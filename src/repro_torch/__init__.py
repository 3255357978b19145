"""``repro_torch`` — the PyTorch/CUDA port of the FLEXA solver stack.

The package mirrors ``repro`` (the JAX reference) module for module, e.g.
``repro_torch.core.flexa`` ↔ ``repro.core.flexa``, and never imports it
or ``jax``.  This slice covers the solo Lasso solve and the screened,
compacted λ-path behind :class:`repro_torch.client.FlexaClient`'s
``inline`` backend, with the compaction gather/scatter as hand-written
CUDA kernels (``repro_torch.kernels``).

Numerics: every tensor is fp32, and matrix products run at full fp32
precision.  Importing the package sets
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
