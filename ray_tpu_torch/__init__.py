"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package imports
``torch`` and nothing of JAX or of ``ray_tpu``. Ported so far: the Llama
family (``models.llama``: forward, loss and gradients, remat), MoE Llama
(``models.moe_llama`` on ``ops.moe``) and ViT (``models.vit``), the
serving engine (``llm.LlamaEngine``) with LoRA folding and the LLM
configuration (``llm``), training on one device (``parallel``: train
state, optimizer, train and eval steps), and hand-written sm_90a kernels
for the flash-attention forward and backward and the fused lm-head
cross-entropy forward and backward (``ops``). Entry
points run on the GPU unless the caller passes ``device="cpu"``; without
a GPU they raise.
"""

from ._private.device import resolve_device

__all__ = ["resolve_device"]
