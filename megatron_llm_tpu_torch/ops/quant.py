"""Weight-only quantization for serving: int8, group-wise int4 and a
per-tensor-class precision policy (mirror of the serving half of
``megatron_llm_tpu/ops/quant.py``).

Three leaf schemes, all plain ``{"q", "scale"}`` dicts:

- **int8 per output channel**: ``w ≈ q * scale``, ``q`` int8 in [-127, 127]
  ``[.., in, out]``, ``scale`` fp32 ``[.., out]`` (``max|w_col| / 127``);
- **int4 group-wise**: ``q`` int4 packed two to a byte along the input
  axis ``[.., in/2, out]`` (the even input row in the low nibble), ``scale``
  fp32 ``[.., n_groups, out]``, one per ``group_size`` input rows.  An int8
  scale drops the input axis, an int4 scale keeps it as the group axis:
  that tells the two apart;
- **int8 per-row embedding**: ``q`` int8 ``[v, h]``, ``scale`` fp32 ``[v]``,
  read by ``embedding_lookup``, which dequantizes only the gathered rows.

``PrecisionPolicy`` names the scheme of each class (attention projections,
MLP projections, the embedding table); norms, biases and the lm_head are
never quantized.  ``mm`` is the one matmul dispatch point of the
transformer's projections.  The codes and scales are the JAX package's bit
for bit: the same fp32 divisions and round-half-to-even.

``int8_training_matmul`` is the training half: W8A8 with both operands
quantized on every call (x per row, w per output column), an int8 x int8
-> int32 product (``torch._int_mm``: cuBLASLt's int8 GEMM on the card)
and a backward that evaluates the dense formulas on the dequantized int8
operands.  ``quantize_specs`` mirrors a quantized tree's structure in a
spec tree (sharded serving, ``serving/cluster/sharded.py``).
"""

from __future__ import annotations

import dataclasses

import torch

QUANT_KEYS = ("q", "scale")

DEFAULT_GROUP_SIZE = 128


def is_quantized(w) -> bool:
    return isinstance(w, dict) and set(w) == set(QUANT_KEYS)


def is_quantized_int4(w) -> bool:
    """int4 leaves keep the input axis on the scale (as the group axis);
    int8 per-channel scales drop it."""
    return is_quantized(w) and w["scale"].ndim == w["q"].ndim


def weight_bits(w) -> int:
    """0 (plain tensor), 8 or 4: the resident width of ``w``."""
    if not is_quantized(w):
        return 0
    return 4 if is_quantized_int4(w) else 8


def int4_group_size(qw: dict) -> int:
    """Rows per scale group of an int4 leaf (q is packed two per byte)."""
    return 2 * qw["q"].shape[-2] // qw["scale"].shape[-2]


def _nonzero(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def quantize_weight(w: torch.Tensor) -> dict:
    """[in, out] (or layer-stacked [L, in, out]) weight → {"q": int8,
    "scale": fp32 [out] / [L, out]}: symmetric, per output channel."""
    w32 = w.float()
    scale = _nonzero(w32.abs().amax(dim=-2) / 127.0)
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., in, out] → packed int8 [..., in/2, out]:
    the even input row in the low nibble, the odd row in the high one."""
    *lead, rows, cols = q.shape
    pairs = q.reshape(*lead, rows // 2, 2, cols).to(torch.int32)
    word = ((pairs[..., 1, :] & 0xF) << 4) | (pairs[..., 0, :] & 0xF)
    return word.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: [..., in/2, out] → int8 [..., in, out].
    The int8 → int32 widening sign-extends; ``(p << 28) >> 28`` and
    ``(p << 24) >> 28`` then sign-extend each nibble, as in JAX."""
    p32 = packed.to(torch.int32)
    low = (p32 << 28) >> 28
    high = (p32 << 24) >> 28
    *lead, r2, cols = packed.shape
    return torch.stack([low, high], dim=-2).reshape(
        *lead, 2 * r2, cols).to(torch.int8)


def quantize_weight_int4(w: torch.Tensor,
                         group_size: int = DEFAULT_GROUP_SIZE) -> dict:
    """[in, out] (or [L, in, out]) weight → int4 group-wise ``{"q": packed
    int8 [..., in/2, out], "scale": fp32 [..., n_groups, out]}``:
    symmetric, ``scale = max|w_group_col| / 7``."""
    w32 = w.float()
    *lead, rows, cols = w32.shape
    if rows % group_size or rows % 2:
        raise ValueError(
            f"int4 group quantization needs group_size ({group_size}) to "
            f"divide the (even) input dim, got {rows}")
    grp = w32.reshape(*lead, rows // group_size, group_size, cols)
    scale = _nonzero(grp.abs().amax(dim=-2) / 7.0)
    q = torch.clamp(torch.round(grp / scale[..., None, :]), -7, 7)
    q = q.reshape(*lead, rows, cols).to(torch.int8)
    return {"q": pack_int4(q), "scale": scale}


def dequantize_weight(qw: dict, dtype=torch.float32) -> torch.Tensor:
    if is_quantized_int4(qw):
        q = unpack_int4(qw["q"]).float()
        scale = qw["scale"]
        *lead, rows, cols = q.shape
        ng = scale.shape[-2]
        deq = q.reshape(*lead, ng, rows // ng, cols) * scale[..., None, :]
        return deq.reshape(*lead, rows, cols).to(dtype)
    return (qw["q"].float() * qw["scale"][..., None, :]).to(dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain or quantized ``w``.

    int8: the weight is cast to x's dtype and the per-column scale applied
    to the product's columns, as in JAX.  int4: the group scales vary along
    the contraction, so the weight is dequantized into x's dtype first.
    XLA fuses either conversion into the dot's read; eager torch writes a
    copy of the weight in x's dtype on every call (its cost is in PERF.md).
    A plain weight is ``x @ w`` (cuBLAS)."""
    if is_quantized(w):
        if is_quantized_int4(w):
            return x @ dequantize_weight(w, x.dtype)
        y = x @ w["q"].to(x.dtype)
        return y * w["scale"].to(x.dtype)
    return x @ w


# ---------------------------------------------------------------------------
# int8 TRAINING matmuls (JAX ops/quant.py:184-242; reference: the optional
# TransformerEngine FP8 path, megatron/model/transformer.py:932-951).  Both
# operands are quantized on every call, the product is int8 x int8 -> int32
# and the rank-1 scale epilogue gives x's dtype back.  The backward
# evaluates dx = g @ w.T and dw = x.T @ g on the *dequantized int8*
# operands, the tensors the forward consumed (TransformerEngine's fp8
# wgrad/dgrad semantics), dw accumulated in fp32; the fp32 master update is
# untouched.  ``round`` is half to even in both packages and the int32 sum
# is exact (k * 127^2 < 2^31 for k below 133 000), so the codes, scales and
# product are JAX's bit for bit.
# ---------------------------------------------------------------------------


def _int8_rowwise(x: torch.Tensor):
    """Symmetric per-row (last-dim) quantization: [..., k] -> (int8 [...,
    k], fp32 scale [..., 1])."""
    x32 = x.float()
    scale = _nonzero(x32.abs().amax(dim=-1, keepdim=True) / 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.library.custom_op("megatron_llm_tpu_torch::int8_operands",
                         mutates_args=())
def _int8_operands_op(x: torch.Tensor, w: torch.Tensor) -> tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(qx, sx, qw["q"], qw["scale"]) as one operator, so that the
    selective recompute policy can name it (``models/transformer.py``:
    JAX keeps a ``custom_vjp``'s residuals)."""
    qx, sx = _int8_rowwise(x)
    qw = quantize_weight(w)
    return qx, sx, qw["q"], qw["scale"]


@_int8_operands_op.register_fake
def _(x, w):
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                        device=x.device),
            torch.empty(w.shape, dtype=torch.int8, device=w.device),
            torch.empty(w.shape[-1:], dtype=torch.float32, device=w.device))


def _int8_operands(x: torch.Tensor, w: torch.Tensor):
    qx, sx, q, scale = _int8_operands_op(x, w)
    return qx, sx, {"q": q, "scale": scale}


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a [m, k]`` x int8 ``b [k, n]`` -> exact int32 ``[m, n]``
    through ``torch._int_mm``.  On the card cuBLASLt wants more than 16
    rows, ``k`` and ``n`` multiples of 8 and ``b`` column-major: the rows
    (a decode step has 1-4), ``k`` and ``n`` are padded with zeros, which
    add exact zeros to the sums, and the result is cut back."""
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a, b)
    mp, kp, np_ = max(_ceil_to(m, 8), 24), _ceil_to(k, 8), _ceil_to(n, 8)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n]


def int32_product_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``int32_product``'s plain version: the same exact sums in fp64,
    whose 53-bit mantissa holds every partial sum of 127^2 products up to
    k = 2^39."""
    return (a.double() @ b.double()).to(torch.int32)


def _int8_dot(qx, sx, qw, out_dtype):
    k, n = qw["q"].shape
    y = int32_product(qx.reshape(-1, k), qw["q"]).reshape(
        *qx.shape[:-1], n).float()
    return (y * sx * qw["scale"]).to(out_dtype)


class _Int8TrainingMatmul(torch.autograd.Function):
    """JAX's ``custom_vjp``: the residuals are the int8 operands and their
    scales, not ``(x, w)``: half the bytes, and the tensors
    TransformerEngine's wgrad/dgrad GEMMs consume."""

    @staticmethod
    def forward(ctx, x, w):
        qx, sx, qw = _int8_operands(x, w)
        ctx.save_for_backward(qx, sx, qw["q"], qw["scale"])
        ctx.dtypes = (x.dtype, w.dtype)
        return _int8_dot(qx, sx, qw, x.dtype)

    @staticmethod
    def backward(ctx, g):
        qx, sx, q, scale = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wd = q.to(g.dtype) * scale.to(g.dtype)
            dx = (g @ wd.T).to(x_dtype)
        if ctx.needs_input_grad[1]:
            # fp32 wgrad accumulation, as the bf16 path keeps it
            xd = (qx.float() * sx).reshape(-1, q.shape[0])
            dw = (xd.T @ g.reshape(-1, q.shape[1]).float()).to(w_dtype)
        return dx, dw


def int8_training_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands dynamically int8-quantized (per-token
    rows x per-output-channel columns); the backward evaluates the dense
    matmul formulas on the dequantized int8 operands."""
    return _Int8TrainingMatmul.apply(x, w)


# The projection leaves a policy quantizes, by tensor class.  Norm scales,
# biases and the lm_head stay as they are; the embedding table has its own
# per-row scheme because a gather, not mm, reads it.
_ATTN_LEAF_NAMES = frozenset({"wq", "wk", "wv", "wo"})
_MLP_LEAF_NAMES = frozenset({"w_gate", "w_up", "w_down"})
_QUANT_LEAF_NAMES = _ATTN_LEAF_NAMES | _MLP_LEAF_NAMES


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-tensor-class precision for the serving quantize transform:
    ``attn`` / ``mlp`` in {"none", "int8", "int4"}, ``embedding`` in
    {"none", "int8"} (untied tables only), ``group_size`` the int4 group
    width."""

    attn: str = "int8"
    mlp: str = "int8"
    embedding: str = "none"
    group_size: int = DEFAULT_GROUP_SIZE


# Named presets, also the serving CLI's --weight_quant vocabulary.
POLICIES = {
    "int8": PrecisionPolicy(),
    "int4": PrecisionPolicy(attn="int4", mlp="int4", embedding="int8"),
    "mixed": PrecisionPolicy(attn="int8", mlp="int4", embedding="int8"),
}


def resolve_policy(policy) -> PrecisionPolicy:
    """None (the int8 preset), a preset name, or a PrecisionPolicy."""
    if policy is None:
        return POLICIES["int8"]
    if isinstance(policy, str):
        return POLICIES[policy]
    return policy


def quantize_embedding(word: torch.Tensor) -> dict:
    """[v, h] table → per-row int8 ``{"q": int8 [v, h], "scale": fp32
    [v]}``."""
    w32 = word.float()
    scale = _nonzero(w32.abs().amax(dim=-1) / 127.0)
    q = torch.clamp(torch.round(w32 / scale[..., None]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def embedding_lookup(word, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """``word[tokens]`` for a plain or int8 table; a quantized table
    dequantizes only the gathered rows."""
    if is_quantized(word):
        x = word["q"][tokens].float() * word["scale"][tokens][..., None]
        return x.to(dtype) if dtype is not None else x
    return word[tokens]


def quantize_params(params: dict, policy=None) -> dict:
    """Serving transform: quantize the layer projection weights (and, under
    the policy, an untied embedding table) of a parameter tree.  Matching
    is by leaf name, on 2-D or layer-stacked 3-D tensors.  An int4 class
    whose input dim the group size does not divide falls back to int8 for
    that leaf (tiny test configs), as in JAX.  Leaves left as they are are
    shared with ``params``, not copied."""
    pol = resolve_policy(policy)
    prec_of = {**{k: pol.attn for k in _ATTN_LEAF_NAMES},
               **{k: pol.mlp for k in _MLP_LEAF_NAMES}}

    def q_leaf(v, prec):
        if prec == "int4" and v.shape[-2] % pol.group_size == 0 \
                and v.shape[-2] % 2 == 0:
            return quantize_weight_int4(v, pol.group_size)
        return quantize_weight(v)

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if (k in _QUANT_LEAF_NAMES and isinstance(v, torch.Tensor)
                    and v.ndim in (2, 3) and prec_of[k] != "none"):
                out[k] = q_leaf(v, prec_of[k])
            else:
                out[k] = walk(v)
        return out

    out = walk(params)
    if (pol.embedding == "int8" and "lm_head" in params
            and isinstance(params.get("embedding", {}).get("word"),
                           torch.Tensor)):
        out["embedding"] = dict(out["embedding"])
        out["embedding"]["word"] = quantize_embedding(
            params["embedding"]["word"])
    return out


def precision_route(params: dict) -> str:
    """The decode precision route a tree selects: "fp32" (no quantized
    projection: the model dtype), "int8", "int4" or "mixed".  The serving
    engine tags its decode steps with it."""
    bits = set()

    def walk(tree):
        if not isinstance(tree, dict) or is_quantized(tree):
            return
        for k, v in tree.items():
            if k in _QUANT_LEAF_NAMES and (not isinstance(v, dict)
                                           or is_quantized(v)):
                bits.add(weight_bits(v))
            else:
                walk(v)

    walk(params.get("layers", params) if isinstance(params, dict)
         else params)
    if not bits or bits == {0}:
        return "fp32"
    if bits == {8}:
        return "int8"
    if bits == {4}:
        return "int4"
    return "mixed"


def quantize_specs(specs: dict, params: dict | None = None) -> dict:
    """The spec tree of a quantized param tree (JAX ``quantize_specs``):
    each quantized leaf's spec becomes ``{"q": spec, "scale": ...}``, the
    scale co-sharded with its ``q``.  An int8 scale ``[.., out]`` takes
    the weight's output axis; an int4 scale ``[.., n_groups, out]`` takes
    it too and keeps the group axis whole (the group count need not
    divide an axis the packed rows divide); the embedding's per-row scale
    ``[v]`` takes the vocab axis.  With ``params`` the tree follows the
    leaves that are quantized and their form (mixed policies); without,
    every projection leaf but a MoE expert stack (rank-4 spec) is taken
    to be int8."""
    def scale_spec(k, t, leaf):
        if k == "word":
            return (t[0],) if t else ()
        if leaf is not None and is_quantized_int4(leaf):
            return t[:-2] + (None, t[-1]) if len(t) >= 2 else ()
        return t[:-2] + (t[-1],) if len(t) >= 2 else ()

    def walk(tree, ptree):
        if isinstance(tree, tuple):
            return tree
        out = {}
        for k, v in tree.items():
            pv = ptree.get(k) if isinstance(ptree, dict) else None
            t = v if isinstance(v, tuple) else ()
            if params is not None:
                if is_quantized(pv):
                    out[k] = {"q": v, "scale": scale_spec(k, t, pv)}
                else:
                    out[k] = walk(v, pv)
                continue
            if k in _QUANT_LEAF_NAMES and isinstance(v, tuple) \
                    and len(t) != 4:
                out[k] = {"q": v, "scale": t[:-2] + (t[-1],)
                          if len(t) >= 2 else ()}
            else:
                out[k] = walk(v, pv)
        return out

    return walk(specs, params)

