"""zkemail_tpu_torch — the PyTorch/CUDA port of zkemail_tpu's Groth16 prover.

It sits beside the JAX package and imports nothing of it (nor JAX): the
modules it needs that hold no JAX are kept here as copies. Layout mirrors
the JAX package:
  core/       BN254 field constants, limb tensors, curve law, pairing
              oracle, Poseidon (and its batched version on tensors)
  ops/        the CUDA kernels (csrc/) with their wrappers, NTT and MSM
  prover/     Groth16 setup, prove, containers, keys on disk
  circuits/   the circuit builder, gadgets and R1CS
  models/     the EmailVerifier and the benchmark's other circuits
  helpers/    DKIM, DNS resolvers, circuit inputs, key recovery
  parallel/   the multi-GPU mesh on torch.distributed
  native/     the C++ Groth16 verifier and its codegen CLI
  contracts/  Python models of the registry contracts (with utils/)
  scripts/    the tools: stress and microbenchmarks, profiles, registry

Entry points run on the CUDA device unless the caller passes device="cpu".
"""
