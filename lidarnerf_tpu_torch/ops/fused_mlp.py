"""Fused bias-free ReLU MLP (counterpart of lidarnerf_tpu/ops/fused_mlp.py).

- `mlp_reference`: the plain version and test oracle;
- `fused_mlp_inference`: kernel B5 (`csrc/fused_mlp.cu`), CUDA tensors only;
- `fused_mlp`: differentiable; B5 forward on a CUDA tensor, the plain
  version on the CPU, and a backward that recomputes through
  `mlp_reference` with autograd, as the JAX package's `_fused_bwd` does
  (it has no backward kernel).

Weights keep the JAX layout, `[d_in, d_out]`. Like the JAX module this is
available for models that want it: the network's own MLPs stay plain
PyTorch layers.
"""

import torch

from lidarnerf_tpu_torch.ops import dispatch


def mlp_reference(x, weights, final_activation="none"):
    """x [Q, d0] through the chain h = relu(h.astype(w.dtype) @ w), float32 out.

    Computes like `jnp.dot(..., preferred_element_type=jnp.float32)`: each
    layer's input is rounded to its weight's dtype, and the product is taken
    in float32, so bfloat16 products are exact and the sums float32 (a
    bfloat16 `torch.matmul` would round its result to bfloat16).
    """
    h = x
    last = len(weights) - 1
    for i, w in enumerate(weights):
        h = h.to(w.dtype).float() @ w.float()
        if i != last:
            h = torch.relu(h)
    if final_activation == "sigmoid":
        h = torch.sigmoid(h)
    elif final_activation == "relu":
        h = torch.relu(h)
    return h


def fused_mlp_inference(x, weights, final_activation="none"):
    """Kernel B5: the whole chain in one launch. CUDA tensors only; raises otherwise."""
    if not dispatch.uses_kernel(x):
        raise ValueError("fused_mlp_inference is kernel B5 and takes CUDA tensors; "
                         "mlp_reference is its plain version")
    from lidarnerf_tpu_torch.ops import fused_mlp_cuda

    return fused_mlp_cuda.fused_mlp_fwd(x.float().contiguous(), [w.contiguous() for w in weights],
                                        final_activation)


class FusedMLP(torch.autograd.Function):
    """B5 forward on CUDA tensors, `mlp_reference` on CPU ones; recompute backward."""

    @staticmethod
    def forward(ctx, x, final_activation, *weights):
        ctx.final_activation = final_activation
        ctx.save_for_backward(x, *weights)
        if dispatch.uses_kernel(x):
            return fused_mlp_inference(x, weights, final_activation)
        return mlp_reference(x, weights, final_activation)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            xx = x.detach().requires_grad_(needs[0])
            ww = [w.detach().requires_grad_(n) for w, n in zip(weights, needs[2:])]
            out = mlp_reference(xx, ww, ctx.final_activation)
            wanted = [t for t in (xx, *ww) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (next(grads) if needs[0] else None, None,
                *[next(grads) if n else None for n in needs[2:]])


def fused_mlp(x, weights, final_activation="none"):
    """Differentiable fused MLP: x [Q, d0], weights [d_i, d_{i+1}] -> [Q, dL] float32."""
    return FusedMLP.apply(x, final_activation, *weights)
