"""Hand-written Hopper kernels for the port's hot spots (E-Attention).

paged_attention.py  paged decode attention over the shared KV slab
                    (CUDA: csrc/paged_attention.cu)
flash_attention.py  blockwise causal/SWA/GQA prefill attention
                    (CUDA: csrc/flash_attention.cu)
moe_experts.py      a MoE layer's SwiGLU over its routed experts only
                    (CUDA: csrc/moe_experts.cu)
rope_kv_write.py    a paged decode step layer's rotary embedding of q and k
                    and its K/V rows written to their pages
                    (CUDA: csrc/rope_kv_write.cu)
add_rms_norm.py     a paged decode step's residual add and the RMSNorm after it
                    (CUDA: csrc/add_rms_norm.cu)
ops.py              device-dispatching entry points and launch counters
ref.py              plain PyTorch versions: run for CPU tensors, and the
                    yardstick the kernels are checked against on the card
build.py            nvcc build (sm_90a) and ctypes loading, at first use
"""
from repro_torch.kernels.ops import (add_rms_norm, add_rms_norm_ref,  # noqa: F401
                                     flash_attention, flash_attention_ref, moe_experts,
                                     moe_experts_ref, paged_attention, paged_attention_ref,
                                     rope_kv_write, rope_kv_write_ref)
