"""Shared building blocks for the model zoo (PyTorch port of
``repro/models/common.py``).

Initializers take an explicit ``device`` and ``torch.Generator`` and draw
each tensor on that device, in fp32, before casting to the parameter type,
so a full-width model never exists in fp32 as a whole.  They follow the
reference's distributions, not its random bits (jax threefry and torch
Philox differ): parity tests carry the reference's weights across with
``repro_torch/convert.py``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import flatten, leaves, tree_map, unflatten

Params = Dict[str, object]

# --------------------------------------------------------------------- #
# products
#
# jnp.matmul and jnp.einsum promote operands of two types to the wider one
# (an fp32 activation against a bf16 weight computes in fp32, the
# reference's fp32 compute over bf16 parameters); torch.matmul takes one
# type only.  These cast both operands to the promoted type where they
# differ, and are plain ``@`` / ``torch.einsum`` where they agree.


def _promoted(*ops: torch.Tensor):
    dtype = ops[0].dtype
    for o in ops[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return [o.to(dtype) for o in ops]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' promoted type."""
    if a.dtype != b.dtype:
        a, b = _promoted(a, b)
    return a @ b


def einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted type."""
    if len({o.dtype for o in ops}) > 1:
        ops = _promoted(*ops)
    return torch.einsum(spec, *ops)


# --------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------- #


def _truncated_normal(shape, lo: float, hi: float, *, device,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normal truncated to [lo, hi], by inverse-CDF sampling."""
    cdf_lo = 0.5 * (1.0 + math.erf(lo / math.sqrt(2.0)))
    cdf_hi = 0.5 * (1.0 + math.erf(hi / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(2.0 * cdf_lo - 1.0, 2.0 * cdf_hi - 1.0, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(lo, hi)


def dense_init(d_in: int, d_out: int, dtype=torch.float32, *, device,
               generator: Optional[torch.Generator] = None,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init, ``[d_in, d_out]`` for ``x @ W``."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = _truncated_normal((d_in, d_out), -2.0, 2.0, device=device,
                          generator=generator)
    return w.mul_(scale).to(dtype)


def embed_init(vocab: int, d: int, dtype=torch.float32, *, device,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    # 1/sqrt(d) scale keeps tied unembedding logits O(1)
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(generator=generator)
    return w.div_(math.sqrt(d)).to(dtype)


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #


def rmsnorm_init(d: int, dtype=torch.float32, *, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def layernorm_init(d: int, dtype=torch.float32, *, device) -> Params:
    return {"bias": torch.zeros((d,), dtype=dtype, device=device),
            "scale": torch.ones((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in fp32 (population variance), then
    cast back to x's type."""
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dtype)


# --------------------------------------------------------------------- #
# activations
# --------------------------------------------------------------------- #


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# --------------------------------------------------------------------- #
# RoPE and M-RoPE
# --------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float, *, device) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2]."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...]: int -> cos/sin [..., head_dim // 2] (fp32)."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., n_heads, head_dim]; cos/sin broadcast [..., 1, head_dim//2].

    Split-halves convention (llama): rotate (x1, x2) halves, in fp32,
    then cast back to x's type.
    """
    dtype = x.dtype
    x = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.

    positions [..., 3] int (t, h, w) per token.  The head_dim // 2 rotary
    frequency channels are split into ``sections`` (t, h, w) groups, each
    driven by its own position coordinate.  Returns cos/sin
    [..., head_dim // 2] (fp32)."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    inv = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions.float()[..., None] * inv              # [..., 3, d2]
    parts, lo = [], 0
    for coord, n in enumerate(sections):
        parts.append(ang[..., coord, lo:lo + n])
        lo += n
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def text_positions(batch: int, seq: int, *, device) -> torch.Tensor:
    """[batch, seq] int32 positions 0..seq-1."""
    return torch.arange(seq, dtype=torch.int32, device=device).expand(batch,
                                                                     seq)


# --------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------- #


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE, in fp32.  logits [..., V] (any dtype, upcast),
    labels [...] integer.  Returns (loss, {"loss", "accuracy", "tokens"})."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((torch.argmax(logits, dim=-1) == labels) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


# --------------------------------------------------------------------- #
# stacked-layer helpers
#
# The training parameters keep the reference's layout: a layer stack is one
# tree whose leaves are [n_layers, ...], so per-leaf top-k selects over the
# whole stacked leaf and the trainer sees the reference's leaves.  The
# reference scans over the stack; the port loops.


def stacked_init(init_one: Callable[[], Params], n_layers: int) -> Params:
    """``init_one()`` per layer, stacked leaf by leaf on a new dim 0."""
    layers = [init_one() for _ in range(n_layers)]
    return tree_map(lambda *xs: torch.stack(xs), *layers)


class _Remat(torch.autograd.Function):
    """One layer under rematerialization (the reference's
    ``jax.checkpoint``): the forward keeps the layer's inputs only (the
    carry, the constants and the layer's leaves), and the backward runs
    the layer again under ``torch.func.vjp`` and pulls the cotangents
    through it.  ``torch.utils.checkpoint`` does not compose with the
    trainer's ``vmap(grad)``; a Function with ``setup_context`` does, and
    the generated vmap rule runs it per learner.  The kernels' own
    Functions (attention, WKV) run inside it, in the forward and in the
    recomputation.  The recomputation does what the forward did, so the
    gradients are the bits of the layer taken without remat."""

    generate_vmap_rule = True

    @staticmethod
    def forward(body, treedef, n_carry, n_const, *tensors):
        carry = tensors[:n_carry]
        consts = tensors[n_carry:n_carry + n_const]
        lp = unflatten(treedef, list(tensors[n_carry + n_const:]))
        return tuple(body(carry, lp, consts))

    @staticmethod
    def setup_context(ctx, inputs, output):
        body, treedef, n_carry, n_const, *tensors = inputs
        ctx.args = (body, treedef, n_carry, n_const)
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *cotangents):
        body, treedef, n_carry, n_const = ctx.args
        saved = ctx.saved_tensors
        # the constants that take a gradient (a decoder layer's encoder
        # output; never cos and sin) are pulled through with the carry
        diff = [j for j in range(n_const)
                if ctx.needs_input_grad[4 + n_carry + j]]
        n_diff = len(diff)

        def layer(*xs):
            consts = list(saved[n_carry:n_carry + n_const])
            for j, c in zip(diff, xs[n_carry:n_carry + n_diff]):
                consts[j] = c
            lp = unflatten(treedef, list(xs[n_carry + n_diff:]))
            return tuple(body(xs[:n_carry], lp, tuple(consts)))

        primals = (saved[:n_carry] + tuple(saved[n_carry + j] for j in diff)
                   + saved[n_carry + n_const:])
        _, vjp = torch.func.vjp(layer, *primals)
        grads = vjp(tuple(cotangents))
        const_grads = [None] * n_const
        for j, g in zip(diff, grads[n_carry:n_carry + n_diff]):
            const_grads[j] = g
        return ((None,) * 4 + tuple(grads[:n_carry]) + tuple(const_grads)
                + tuple(grads[n_carry + n_diff:]))


def scan_layers(body: Callable, carry, stacked_params: Params, *,
                remat: bool = False, consts: Tuple = ()):
    """``carry = body(carry, layer_params, *consts)`` over the layers of a
    stacked tree; ``carry`` is a tensor or a tuple of tensors.

    ``remat=True`` recomputes each layer in the backward instead of
    keeping its activations (:class:`_Remat`): memory only, the same
    bits.  Tensors the body reads besides the carry and its leaves (cos
    and sin, a decoder's encoder output) go in ``consts``, so that the
    recomputation reads them as the forward did under the trainer's vmap;
    a const that needs a gradient takes it through the recomputation."""
    single = isinstance(carry, torch.Tensor)
    carry = (carry,) if single else tuple(carry)
    consts = tuple(consts)

    def step(c, lp, cs):
        out = body(c[0] if single else c, lp, *cs)
        return (out,) if single else tuple(out)

    for i in range(leaves(stacked_params)[0].shape[0]):
        lp = tree_map(lambda a: a[i], stacked_params)
        if remat:
            flat, treedef = flatten(lp)
            carry = _Remat.apply(step, treedef, len(carry), len(consts),
                                 *carry, *consts, *flat)
        else:
            carry = step(carry, lp, consts)
    return carry[0] if single else carry


def scan_layers_with_cache(body: Callable, x, layers, cache: List):
    """``x, cache[i] = body(x, layer_i, cache[i])`` over the layers in
    order; returns (x, the new caches).  ``layers`` is a sequence of
    per-layer params (a ``ModuleList``) or a stacked tree, sliced per
    layer; ``cache`` a list of per-layer caches (the reference stacks them
    on the layer dim and threads them through its scan)."""
    new = []
    for i, lc in enumerate(cache):
        lp = tree_map(lambda a: a[i], layers) \
            if isinstance(layers, Mapping) else layers[i]
        x, lc = body(x, lp, lc)
        new.append(lc)
    return x, new
