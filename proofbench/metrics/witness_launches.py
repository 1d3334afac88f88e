"""witness_launches (program counter): K1 (mont_mul) kernel launches in
eval_witness per request (field_kernels.LAUNCHES), over the window."""


def read(run: dict):
    done = [b for b in run["batches"] if "k1_witness" in b]
    n = sum(b["requests"] for b in done)
    return sum(b["k1_witness"] for b in done) / n if n else None
