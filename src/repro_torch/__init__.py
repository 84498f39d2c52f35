"""``repro_torch`` — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Same subpackages and module names as ``repro`` (``core``, ``kernels``,
``index``, ...), so each module's JAX counterpart is one path away. The
JAX package stays the reference; nothing here imports it.

Float32 matmul precision is pinned here, once, for the whole package:
TF32 keeps a 10-bit mantissa (about three decimal digits), and
``unq_encode`` is an argmax over dot products, so TF32 would flip codes
wherever two codewords score within ~1e-3 of each other, and the LUTs
and decoder distances would drift from the reference by the same order.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
