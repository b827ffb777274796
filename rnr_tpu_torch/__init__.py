"""PyTorch + CUDA port of rnr_tpu (relightable neural renderer).

The package mirrors `rnr_tpu`'s module paths.  Every Pallas kernel on the
ported path has a hand-written CUDA C++ kernel for Hopper (sm_90a) in
`csrc/`, built with nvcc at first use and bound through ctypes, and a plain
PyTorch twin in the same module.  A tensor on the CPU always goes to the
twin; a tensor on a CUDA device always goes to the kernel, which raises if
it cannot build or launch.

Layout follows the JAX package: NHWC at every public boundary.  Nothing
here imports JAX or any module of `rnr_tpu`: what the port needs from it
(the config dataclasses, the synthetic inputs) it keeps as its own copy.
The entry points (`RNRModel`, `make_generator`) build on the current CUDA
device unless the caller passes `device="cpu"`, and raise without a card.
"""
