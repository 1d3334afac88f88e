"""The least work of the layers whose roofline share the benchmark reports,
counted from shapes alone, and the chip's peaks.

Copied from ``chip_smoke.py`` (``OPS_MUL``, ``OPS_ADD``, ``KERNELS``,
``INT32_PER_CLK_PER_SM``, ``HBM_BYTES_PER_S``): operations are 32-bit
integer results on the field's 8 x 32-bit words, whatever layout a kernel
uses. A Montgomery product is 2 * 2 * 8 * 8 multiply-adds, 8 quotient
products and 16 operations of the final subtraction: 280. An addition or
subtraction is two 8-word carry chains and 8 selects: 24. A share is the
least time (the larger of operations over the integer peak and bytes over
the memory peak) over the measured time, and the bound that sets the least
time is named beside it.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

OPS_MUL = 2 * 2 * 8 * 8 + 8 + 16
OPS_ADD = 24
WORD_BYTES = 32  # a field element as 8 x 32-bit words
L = 22  # the port's interchange limbs, which K2 reads and writes
# K2 ec_add_g1 per lane (chip_smoke.py KERNELS): 12 products and 27
# additions; it reads two points and writes one, 9 coordinates of L limbs,
# and one int32 flag. A negated addend's one more subtraction is left out.
K2_OPS = 12 * OPS_MUL + 27 * OPS_ADD
K2_BYTES = 9 * L * 4 + 4
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def card_peaks(device) -> dict:
    """int32 results per second (64 a clock per SM at the maximum SM clock
    nvidia-smi reports) and bytes per second of the card."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader",
                          "-i", str(torch.device(device).index or 0)],
                         capture_output=True, text=True, check=True).stdout
    mhz = float(out.split()[0])
    return {"int32_per_s": sms * PEAKS["int32_results_per_clock_per_sm"] * mhz * 1e6,
            "bytes_per_s": PEAKS["hbm_bytes_per_s"], "sms": sms, "max_sm_mhz": mhz}


def h_stage_work(shapes: dict, batch: int) -> tuple[float, float]:
    """(int32 operations, bytes) of the h stage of one batch: per proof the
    products of A w and B w (one per nonzero) and the row sums (nonzeros
    less nonempty rows, additions), m products for C w = A w o B w, three
    inverse NTTs and three shifted NTTs of (m / 2) log2 m butterflies (a
    product, an addition and a subtraction each), one coset scaling per
    polynomial (m products: the shift and the inverse's 1/m folded), and
    a * b - c (m products and m subtractions). Bytes: the matrices (a 32-byte
    coefficient and two 4-byte indices a nonzero) read once a batch, each
    proof's witness read and its m evaluations written once."""
    m, log_m = 1 << shapes["log_m"], shapes["log_m"]
    nnz = shapes["nnz_A"] + shapes["nnz_B"]
    sums = nnz - shapes["rows_A"] - shapes["rows_B"]
    butterflies = 6 * (m // 2) * log_m
    ops = (nnz * OPS_MUL + sums * OPS_ADD + m * OPS_MUL
           + butterflies * (OPS_MUL + 2 * OPS_ADD) + 3 * m * OPS_MUL
           + m * (OPS_MUL + OPS_ADD))
    per_proof_bytes = (shapes["n_signals"] + m) * WORD_BYTES
    return batch * ops, nnz * (WORD_BYTES + 8) + batch * per_proof_bytes


def least_time(ops: float, nbytes: float, peaks: dict) -> tuple[float, str]:
    """(seconds, "operations" | "bytes") of work at the card's peaks."""
    by_ops, by_bytes = ops / peaks["int32_per_s"], nbytes / peaks["bytes_per_s"]
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
