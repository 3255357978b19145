"""``repro_torch`` — the PyTorch/CUDA port of the FLEXA solver stack.

The package mirrors ``repro`` (the JAX reference) module for module, e.g.
``repro_torch.core.flexa`` ↔ ``repro.core.flexa``, and never imports it
or ``jax``.  Ported so far: the solo Lasso solve and the screened,
compacted λ-path behind :class:`repro_torch.client.FlexaClient`'s
``inline`` backend; serving of the ``dense``, ``ssm``, ``hybrid`` and
``moe`` LM families (``repro_torch.serve``); training of the ``dense``
LM family with FLEXA
or AdamW (``repro_torch.train``).  Each TPU kernel on those paths is a
hand-written CUDA kernel (``repro_torch.kernels``).

Numerics: solver tensors are fp32, LM activations bf16 or fp32 over fp32
master weights, and fp32 matrix products run at full fp32 precision.  Importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` once, so a CUDA run computes
what the CPU run computes up to summation order.

Devices: entry points take an explicit ``device`` and default to
``"cuda"``; a CUDA request on a machine without CUDA raises (see
:func:`repro_torch.device.resolve_device`).  Pass ``device="cpu"`` to
run on the host, as the tests do.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
