"""Hand-written Hopper kernels for the port's hot spots (E-Attention).

paged_attention.py  paged decode attention over the shared KV slab
                    (CUDA: csrc/paged_attention.cu)
flash_attention.py  blockwise causal/SWA/GQA prefill attention
                    (CUDA: csrc/flash_attention.cu)
ops.py              device-dispatching entry points and launch counters
ref.py              plain PyTorch versions: run for CPU tensors, and the
                    yardstick the kernels are checked against on the card
build.py            nvcc build (sm_90a) and ctypes loading, at first use
"""
from repro_torch.kernels.ops import (flash_attention, flash_attention_ref,  # noqa: F401
                                     paged_attention, paged_attention_ref)
