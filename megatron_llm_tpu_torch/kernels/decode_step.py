"""Fused single-token decode step: the whole layer stack in one launch.

Replaces the TPU kernels of ``megatron_llm_tpu/kernels/decode_step.py``:

- ``fused_decode_step`` (K12, ``_decode_step_kernel``): a dense cache
  ``[L, b, kv, max_len, d]`` and a scalar or ``[b]`` fill;
- ``fused_decode_step_paged`` (K13, ``_decode_step_kernel_paged`` at
  window 1): the cache read from the serving block pool ``[L, n_blocks,
  kv, block, d]`` through per-slot tables ``[b, T]``;
- ``fused_decode_verify_paged`` (K14, the same kernel at window W): a
  W-wide speculative window per slot, each position bitwise what W
  sequential K13 steps (with the host's pool writes between them) give;
- ``fused_decode_verify_tree_paged`` (K14's tree mode, the same call with
  ``depths``/``anc``): the window columns are the nodes of a candidate
  tree, each node bitwise what sequential K13 steps down its root path
  give (``fused_decode_verify_paged(depths=, anc=)`` routes here).

All of them run ``csrc/decode_step.cu`` on a CUDA tensor (one cooperative
launch per call; what bounds it and how it is laid out is written at the
top of the source: bf16 streams the weights through TMA boxes into a ring
fed by a producer warpgroup, fp32 runs a CUDA-core body, and the C
launcher reports which ran, counted in ``<wrapper>.tma_launches``) and the
plain PyTorch version of this module on a CPU tensor.  Every layer:
RMSNorm, the q/k/v GEMVs (an int8 weight's column
scale after the dot and before RoPE, an int4 tile dequantized group-wise
as it loads), interleaved-pair RoPE at each row's own position, attention
over the row's cache columns ``[0, fill)`` with the row's own new K/V
folded in last, wo and the residual, RMSNorm, gate/up, ``act(gate) * up``
in the compute dtype, w_down in ``mlp_chunks`` partial sums added to the
residual one after the other.  The residual stays fp32 across all layers.

Each call returns ``(hidden [rows, h], k_rows [L, rows, kv, 1, d],
v_rows)``: hidden is the stack output before the final norm, in x's dtype;
the rows are the new K/V in the cache's dtype, or for an int8 cache fp32
values already ``fake_quantize_rows``-ed, which the caller's
``quantize_rows`` maps to the very codes the kernel attended.

``lora=(arenas, mask)`` adds the multi-tenant LoRA epilogue of
``ops/lora.py`` (JAX ``_decode_step_kernel``'s ``lora_add``): for every
target in the arenas, ``y += ((x·A) ⊙ mask)·B`` in fp32 with the fp32
input (the normed residual, the context, ``act(gate) * up``), never the
compute-dtype copy the base product reads; q/k/v take it after the int8
scale and before RoPE, wo and gate/up after their products, and w_down
once after the last MLP chunk.  The mask is ``[rows, Sr]`` (K14: per slot
``[S, Sr]``, repeated over the window, so drafts verify under the
requester's adapter).  A row whose mask row is zero gets the no-arena
numbers.  The wrappers count a launch with an arena apart
(``<wrapper>.lora.launches``).

Not ported: the TPU kernel's ``DECODE_STEP_PHASES`` debug switch (its
outputs are garbage by design).
"""

from __future__ import annotations

import ctypes
import math
import types
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.activations import is_glu
from ..ops.kv_quant import fake_quantize_rows, is_quantized_cache, \
    quantize_rows
from ..ops.lora import LORA_TARGETS, arena_sr, lora_delta
from ..ops.quant import int4_group_size, is_quantized, weight_bits
from . import build

NEG_INF = -1e30

# the gate activation of each GLU family member (gate and up are separate
# operands here, so the base function applies to the gate)
GLU_BASE = {
    "swiglu": F.silu,
    "geglu": lambda x: F.gelu(x, approximate="tanh"),
    "reglu": F.relu,
    "liglu": lambda x: x,
}
_ACT_CODES = {"swiglu": 0, "geglu": 1, "reglu": 2, "liglu": 3}

# What the CUDA kernel takes (csrc/decode_step.cu states the same limits)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_GROUP = 8
KERNEL_MAX_ROWS = 64      # rows of one call: slots x window
KERNEL_MAX_WINDOW = 8
KERNEL_TILE = 32          # GEMV output columns per tile
KERNEL_MIN_BLOCK = 16     # pool blocks: powers of two from 16
# LoRA arenas: the stacked rank in whole 32-column tiles, at most 32 tiles
# (one bit each in the kernel's 32-bit word of tiles some row selects);
# x·A runs in 512-row contraction chunks
KERNEL_MAX_LORA_SR = 1024
KERNEL_LORA_CHUNK = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BODY_TMA = 2     # the launcher's report: the TMA weight stream (bf16)


# ---------------------------------------------------------------------------
# Helpers: RoPE, int4 tiles, MLP chunks
# ---------------------------------------------------------------------------


def rope_rotation_matrix(cos: torch.Tensor, sin: torch.Tensor, pos: int,
                         d: int) -> torch.Tensor:
    """[d, d] fp32 linear map equal to interleaved-pair RoPE at ``pos``:
    ``x @ R`` gives out[2i] = x[2i] c_i - x[2i+1] s_i and out[2i+1] =
    x[2i] s_i + x[2i+1] c_i (ops/rope.py:apply_rope at one position)."""
    c = cos[pos, :d // 2].float()
    s = sin[pos, :d // 2].float()
    i = torch.arange(d, device=cos.device)
    even = torch.arange(0, d, 2, device=cos.device)
    r = torch.zeros((d, d), dtype=torch.float32, device=cos.device)
    r[i, i] = torch.repeat_interleave(c, 2)
    r[even, even + 1] = s
    r[even + 1, even] = -s
    return r


def pair_swap_matrix(d: int, device=None) -> torch.Tensor:
    """[d, d] permutation: ``x @ P`` swaps each (2i, 2i+1) pair.  Per-row
    RoPE factors as ``x * C + (x @ P) * S`` with the ``rope_rows``
    vectors."""
    even = torch.arange(0, d, 2, device=device)
    p = torch.zeros((d, d), dtype=torch.float32, device=device)
    p[even, even + 1] = 1.0
    p[even + 1, even] = 1.0
    return p


def rope_rows(rope: tuple, pos: torch.Tensor, d: int):
    """Per-row RoPE factors ``(C, S)`` ``[rows, d]`` fp32 at positions
    ``pos`` ``[rows]``: C repeats each pair's cos, S its sin with the sign
    of the pair's first lane flipped.  Positions past the table clamp to
    its last row (a verify window near the end reaches past it; the
    caller discards those rows' logits, the read must stay in bounds)."""
    cos, sin = rope
    rpos = torch.clamp(pos.to(torch.long), max=cos.shape[0] - 1)
    c_half = cos[rpos, :d // 2].float()
    s_half = sin[rpos, :d // 2].float()
    sign = torch.where(torch.arange(d, device=cos.device) % 2 == 0, -1.0,
                       1.0)
    return (torch.repeat_interleave(c_half, 2, dim=-1).contiguous(),
            (torch.repeat_interleave(s_half, 2, dim=-1)
             * sign[None, :]).contiguous())


def _rope_apply(y: torch.Tensor, c: torch.Tensor, s: torch.Tensor):
    """``y * C + (y @ P) * S`` over heads: y ``[rows, heads, d]`` fp32."""
    z = y.reshape(*y.shape[:-1], -1, 2).flip(-1).reshape(y.shape)
    return y * c[:, None, :] + z * s[:, None, :]


def int4_tile(packed: torch.Tensor, scale: torch.Tensor, cdt,
              gsz: int) -> torch.Tensor:
    """Packed int4 ``[rows/2, cols]`` + group scales ``[rows/gsz, cols]``
    → ``[rows, cols]`` in ``cdt``: the even row in the low nibble, each
    nibble sign-extended by ``(p << 28) >> 28`` / ``(p << 24) >> 28``,
    times its group's scale in fp32, then rounded to ``cdt``."""
    p32 = packed.to(torch.int32)
    low = (p32 << 28) >> 28
    high = (p32 << 24) >> 28
    r2, cols = p32.shape
    v = torch.stack([low, high], dim=1).reshape(2 * r2, cols)
    v = v.float().reshape(-1, gsz, cols) * scale[:, None, :].float()
    return v.reshape(2 * r2, cols).to(cdt)


def mlp_chunks(ffn: int, cap: int = 4) -> int:
    """Number of w_down partial sums: the largest divisor of ffn/128 up to
    ``cap``.  The residual takes them one after the other, in order."""
    lanes = ffn // 128
    for nm in range(cap, 0, -1):
        if lanes and lanes % nm == 0:
            return nm
    return 1


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------


def _stack_eligible(cfg, params):
    """The config/params checks shared by the three predicates (JAX
    ``_stack_eligible``, without its TPU platform and VMEM terms; the CUDA
    kernel's own limits take their place).  None when the stack cannot
    fuse, else ``(aq, mq, gsz)``: the stored bits of the attention and MLP
    projection classes (0 plain, 8 int8, 4 int4) and the int4 group size
    (0 without int4)."""
    if not getattr(cfg, "fused_decode", True):
        return None
    return _stack_form(cfg, params)


def _stack_form(cfg, params):
    """``_stack_eligible`` without the config's ``fused_decode`` switch:
    what the kernel itself takes."""
    from ..config import PositionEmbeddingType

    if (cfg.norm_type != "rmsnorm" or cfg.parallel_attn
            or cfg.num_experts > 0 or cfg.use_bias or cfg.qkv_bias
            or not is_glu(cfg.activation) or cfg.activation not in GLU_BASE
            or cfg.quantize_matmuls != "none"
            or cfg.position_embedding_type != PositionEmbeddingType.ROTARY):
        return None
    layers = params["layers"]
    if "mlp_norm" in layers or "w_gate" not in layers["mlp"]:
        return None
    attn_ws = tuple(layers["attn"][k] for k in ("wq", "wk", "wv", "wo"))
    mlp_ws = tuple(layers["mlp"][k] for k in ("w_gate", "w_up", "w_down"))

    def class_bits(ws):
        bits = {weight_bits(w) for w in ws}
        return bits.pop() if len(bits) == 1 else None

    aq, mq = class_bits(attn_ws), class_bits(mlp_ws)
    if aq is None or mq is None or (aq == 0) != (mq == 0):
        return None
    gszs = {int4_group_size(w) for w in attn_ws + mlp_ws
            if weight_bits(w) == 4}
    if len(gszs) > 1:
        return None
    gsz = gszs.pop() if gszs else 0
    if not _kernel_fits_stack(cfg, params, aq, mq, gsz):
        return None
    return aq, mq, gsz


def _kernel_fits_stack(cfg, params, aq, mq, gsz) -> bool:
    """The CUDA kernel's limits on the model: head dim 64 or 128, a GQA
    group up to 8, GEMV widths in whole 32-column tiles, w_down chunks in
    whole tiles (and whole int4 groups), plain weights in the model's
    fp32 or bf16."""
    d, h, ffn = cfg.head_dim, cfg.hidden_size, cfg.ffn_size
    nq, nkv = cfg.num_attention_heads, cfg.kv_heads
    if d not in KERNEL_HEAD_DIMS or nq % nkv or nq // nkv > KERNEL_MAX_GROUP:
        return False
    nm = mlp_chunks(ffn)
    if h % KERNEL_TILE or ffn % (nm * KERNEL_TILE):
        return False
    if cfg.dtype not in _DTYPE_CODES:
        return False
    if aq == 0 and params["layers"]["attn"]["wq"].dtype != cfg.dtype:
        return False
    if gsz and (gsz % 2 or (aq == 4 and (h % gsz or (nq * d) % gsz))
                or (mq == 4 and (h % gsz or (ffn // nm) % gsz))):
        return False
    return True


def _cache_fits(cfg, cache) -> bool:
    """The cache forms the kernel reads: the int8 form, or the model's
    dtype."""
    return is_quantized_cache(cache) or cache.dtype == cfg.dtype


def lora_fits(lora_sr: int) -> bool:
    """A stacked LoRA rank the kernel takes (0: no arena): whole 32-column
    tiles, at most ``KERNEL_MAX_LORA_SR`` (JAX's ``% 128`` is a TPU lane
    term and its VMEM arena term has no counterpart: the arenas stream
    from device memory and the x·A partial sums live in scratch)."""
    return lora_sr == 0 or (lora_sr % KERNEL_TILE == 0
                            and 0 < lora_sr <= KERNEL_MAX_LORA_SR)


def mesh_shards_stack(mesh) -> bool:
    """True where ``mesh`` splits the stack's weights or cache (pp over
    layers, tp over heads, fsdp over residency; JAX
    ``_mesh_shards_stack``): the whole-stack kernels run one device's
    whole stack in one launch, so such a mesh takes the composed route
    (each layer's products, collectives and attention at the rank's
    shapes).  A mesh of size-1 axes changes nothing."""
    if mesh is None:
        return False
    return mesh.size("pp") * mesh.size("tp") * mesh.size("fsdp") > 1


def fused_decode_eligible(cfg, params, k_cache, s: int,
                          lora_sr: int = 0, mesh=None) -> bool:
    """The dense fused route (K12) for ``forward_cached``: one new token
    (``s == 1``), the stack checks, a batch and a LoRA arena the kernel
    takes, and no ``mesh`` that splits the stack.  It does not look at
    the device: on the CPU the route runs the plain version."""
    if s != 1 or not lora_fits(lora_sr) or mesh_shards_stack(mesh):
        return False
    if _stack_eligible(cfg, params) is None or not _cache_fits(cfg, k_cache):
        return False
    b = _leaf(k_cache).shape[1]
    return 1 <= b <= KERNEL_MAX_ROWS


def _pool_fits(cfg, params, k_pool, rows: int, table_blocks: int) -> bool:
    if rows < 1 or rows > KERNEL_MAX_ROWS or table_blocks < 1:
        return False
    if _stack_eligible(cfg, params) is None or not _cache_fits(cfg, k_pool):
        return False
    block = _leaf(k_pool).shape[3]
    return block >= KERNEL_MIN_BLOCK and block & (block - 1) == 0


def fused_paged_decode_eligible(cfg, params, k_pool, n_slots: int,
                                table_blocks: int,
                                lora_sr: int = 0, mesh=None) -> bool:
    """The paged fused route (K13) for the engine's decode step: the stack
    checks, a power-of-two pool block from 16, a slot count and a LoRA
    arena the kernel takes, and no ``mesh`` that splits the stack (the
    sharded engine's: ``mesh_shards_stack``)."""
    return (not mesh_shards_stack(mesh) and lora_fits(lora_sr)
            and _pool_fits(cfg, params, k_pool, n_slots, table_blocks))


def fused_paged_verify_eligible(cfg, params, k_pool, n_slots: int,
                                window: int, table_blocks: int,
                                lora_sr: int = 0, mesh=None) -> bool:
    """The speculative verify route (K14, a linear window or a tree):
    K13's checks over ``n_slots * window`` rows, a window up to 8, and
    no ``mesh`` that splits the stack."""
    if not lora_fits(lora_sr) or window < 1 or window > KERNEL_MAX_WINDOW \
            or mesh_shards_stack(mesh):
        return False
    return _pool_fits(cfg, params, k_pool, n_slots * window, table_blocks)


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def _leaf(cache) -> torch.Tensor:
    return cache["q"] if isinstance(cache, dict) else cache


def _weight(w, layer: int, cdt):
    """One layer's weight as ``(matrix in cdt, column scale or None)``:
    int8 codes cast exactly with the scale kept for after the dot; int4
    dequantized group-wise (``int4_tile``)."""
    if not is_quantized(w):
        return w[layer], None
    if weight_bits(w) == 4:
        return int4_tile(w["q"][layer], w["scale"][layer], cdt,
                         int4_group_size(w)), None
    return w["q"][layer].to(cdt), w["scale"][layer]


def _dot(xc: torch.Tensor, w, layer: int, cdt, rows: slice = None):
    """``xc @ W`` with fp32 products and sums (``xc`` already in cdt),
    then an int8 column scale; ``rows`` restricts the contraction."""
    mat, scale = _weight(w, layer, cdt)
    if rows is not None:
        mat = mat[rows]
    y = xc.float() @ mat.float()
    return y if scale is None else y * scale.float()


def _rms(x32: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                             + eps) * w.float()


def _cache_cols(cache, layer: int, row: int, n: int) -> torch.Tensor:
    """fp32 ``[kv, n, d]`` copy of columns ``[0, n)`` of one row (an int8
    cache dequantized as ``dequantize_cache`` does)."""
    if isinstance(cache, dict):
        q = cache["q"][layer, row, :, :n].float()
        return (q * cache["scale"][layer, row, :, :n, None]).contiguous()
    return cache[layer, row, :, :n].float().contiguous()


def _attend_row(q, kc, vc, kn, vn, g: int, scale: float):
    """One row's decode attention: q ``[nq, d]``, its cache columns ``[kv,
    n, d]`` and its own new K/V ``[kv, d]`` folded in last."""
    nkv, n, d = kc.shape
    qg = q.reshape(nkv, g, d)
    s_old = (qg @ kc.transpose(1, 2)) * scale               # [kv, g, n]
    s_new = (qg * kn[:, None, :]).sum(-1, keepdim=True) * scale
    s = torch.cat([s_old, s_new], dim=-1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ctx = (p[..., :n] @ vc + p[..., n:] * vn[:, None, :]) \
        / p.sum(-1, keepdim=True)
    return ctx.reshape(nkv * g * d)


def _lora_epi(lora, target: str, layer: int, x32: torch.Tensor):
    """The LoRA delta of ``target`` at ``layer`` for fp32 inputs ``x32``
    ``[rows, in]`` (None without an arena for it)."""
    if lora is None or target not in lora[0]:
        return None
    f = lora[0][target]
    return lora_delta(x32, f["a"][layer], f["b"][layer], lora[1])


def _plus(y: torch.Tensor, delta) -> torch.Tensor:
    return y if delta is None else y + delta


def _plain_stack(cfg, stacked, x, k_view, v_view, fills, rope, lora=None):
    """The stack for one new token per row over dense views ``[L, rows,
    kv, width(, d)]`` (row r attends its columns ``[0, fills[r])`` and sits
    at position ``fills[r]``) → ``(hidden, k_rows, v_rows)`` as the
    wrappers return them.  Each row's attention reads exactly its own
    columns, so a row's numbers do not depend on the view's width: over
    the tables' gathered view the paged step gives the dense step's bits.
    ``lora`` is ``(arenas, [rows, Sr] mask)``; each delta is added where
    the kernel adds it, from the fp32 input the kernel reads."""
    L = _leaf(k_view).shape[0]
    rows, h = x.shape
    nq, nkv, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    g = nq // nkv
    cq8 = is_quantized_cache(k_view)
    cdt = x.dtype
    eps = float(cfg.norm_eps)
    scale = 1.0 / math.sqrt(d)
    act = GLU_BASE[cfg.activation]
    nm = mlp_chunks(cfg.ffn_size)
    fc = cfg.ffn_size // nm
    fills_l = [int(f) for f in fills.tolist()]
    c_rows, s_rows = rope_rows(rope, fills, d)
    attn, mlp = stacked["attn"], stacked["mlp"]
    row_dt = torch.float32 if cq8 else _leaf(k_view).dtype
    k_out = torch.empty((L, rows, nkv, 1, d), dtype=row_dt, device=x.device)
    v_out = torch.empty_like(k_out)
    x32 = x.float()
    for li in range(L):
        xn32 = _rms(x32, stacked["input_norm"]["scale"][li], eps)
        xn = xn32.to(cdt)
        q = _plus(_dot(xn, attn["wq"], li, cdt),
                  _lora_epi(lora, "wq", li, xn32)).reshape(rows, nq, d)
        k = _plus(_dot(xn, attn["wk"], li, cdt),
                  _lora_epi(lora, "wk", li, xn32)).reshape(rows, nkv, d)
        v = _plus(_dot(xn, attn["wv"], li, cdt),
                  _lora_epi(lora, "wv", li, xn32)).reshape(rows, nkv, d)
        q = _rope_apply(q, c_rows, s_rows)
        k = _rope_apply(k, c_rows, s_rows)
        if cq8:
            k, v = fake_quantize_rows(k), fake_quantize_rows(v)
        k_out[li, :, :, 0] = k.to(row_dt)
        v_out[li, :, :, 0] = v.to(row_dt)
        ctx = torch.stack([
            _attend_row(q[r], _cache_cols(k_view, li, r, fills_l[r]),
                        _cache_cols(v_view, li, r, fills_l[r]), k[r], v[r],
                        g, scale) for r in range(rows)])
        x32 = x32 + _plus(_dot(ctx.to(cdt), attn["wo"], li, cdt),
                          _lora_epi(lora, "wo", li, ctx))
        xn2_32 = _rms(x32, stacked["post_attn_norm"]["scale"][li], eps)
        xn2 = xn2_32.to(cdt)
        hid32 = (act(_plus(_dot(xn2, mlp["w_gate"], li, cdt),
                           _lora_epi(lora, "w_gate", li, xn2_32)))
                 * _plus(_dot(xn2, mlp["w_up"], li, cdt),
                         _lora_epi(lora, "w_up", li, xn2_32)))
        hid = hid32.to(cdt)
        for c in range(nm):
            sl = slice(c * fc, (c + 1) * fc)
            x32 = x32 + _dot(hid[:, sl], mlp["w_down"], li, cdt, rows=sl)
        x32 = _plus(x32, _lora_epi(lora, "w_down", li, hid32))
    return x32.to(x.dtype), k_out, v_out


def _gather(pool, tables: torch.Tensor, pad: int = 0):
    """Pool leaves ``[L, n_blocks, kv, block(, d)]`` read through tables
    ``[S, T]`` → new dense views ``[L, S, kv, T*block + pad(, d)]``."""
    S, T = tables.shape
    flat = tables.reshape(-1).to(torch.long)

    def g(a):
        L, _, kv, bk = a.shape[:4]
        tail = tuple(a.shape[4:])
        x = a.index_select(1, flat).view((L, S, T, kv, bk) + tail)
        x = x.transpose(2, 3).reshape((L, S, kv, T * bk) + tail)
        if pad:
            x = torch.cat([x, x.new_zeros((L, S, kv, pad) + tail)], dim=3)
        return x

    if isinstance(pool, dict):
        return {k: g(v) for k, v in pool.items()}
    return g(pool)


def _write_rows(view, rows: torch.Tensor, pos: torch.Tensor) -> None:
    """The host's write of returned rows ``[L, S, kv, 1, d]`` into a dense
    view at each slot's ``pos``: cast to the view's dtype, or for an int8
    view through ``quantize_rows`` (both leaves)."""
    ar = torch.arange(rows.shape[1], device=rows.device)
    pos = pos.to(torch.long)
    if isinstance(view, dict):
        qr = quantize_rows(rows)
        view["q"][:, ar, :, pos] = qr["q"][:, :, :, 0].transpose(0, 1)
        view["scale"][:, ar, :, pos] = qr["scale"][:, :, :, 0].transpose(0, 1)
        return
    view[:, ar, :, pos] = rows[:, :, :, 0].transpose(0, 1).to(view.dtype)


def _fills(cache_len, b: int, device) -> torch.Tensor:
    return torch.as_tensor(cache_len, device=device).to(
        torch.long).reshape(-1).expand(b)


def fused_decode_step_plain(cfg, stacked, x, k_cache, v_cache, cache_len,
                            rope, lora=None):
    """K12's function in plain torch."""
    return _plain_stack(cfg, stacked, x, k_cache, v_cache,
                        _fills(cache_len, x.shape[0], x.device), rope, lora)


def fused_decode_step_paged_plain(cfg, stacked, x, k_pool, v_pool, tables,
                                  fills, rope, lora=None):
    """K13's function: K12's over the tables' gathered view."""
    tables = torch.as_tensor(tables, device=x.device)
    return fused_decode_step_plain(cfg, stacked, x, _gather(k_pool, tables),
                                   _gather(v_pool, tables), fills, rope,
                                   lora)


def fused_decode_verify_paged_plain(cfg, stacked, x, k_pool, v_pool, tables,
                                    fills, rope, lora=None):
    """K14's function: W sequential single-token steps over one gathered
    view, each step's rows written back as the host writes them into the
    pool (cast to the pool's dtype, or ``quantize_rows``), so window
    position j sees rows 0..j-1 exactly as a pool round trip returns
    them.  → ``(hidden [S, W, h], k_rows [L, S*W, kv, 1, d], v_rows)``.
    ``lora``'s mask is per slot, ``[S, Sr]``."""
    S, W, _ = x.shape
    tables = torch.as_tensor(tables, device=x.device)
    fills = _fills(fills, S, x.device)
    kd, vd = _gather(k_pool, tables, W), _gather(v_pool, tables, W)
    hs, ks, vs = [], [], []
    for j in range(W):
        hj, kr, vr = _plain_stack(cfg, stacked, x[:, j], kd, vd, fills + j,
                                  rope, lora)
        hs.append(hj)
        ks.append(kr)
        vs.append(vr)
        if j + 1 < W:
            _write_rows(kd, kr, fills + j)
            _write_rows(vd, vr, fills + j)

    def rows(parts):
        r = torch.stack(parts, dim=2)                # [L, S, W, kv, 1, d]
        return r.reshape((r.shape[0], S * W) + tuple(r.shape[3:]))

    return torch.stack(hs, dim=1), rows(ks), rows(vs)


def check_tree(depths: torch.Tensor, anc: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``depths`` ``[S, W]`` / ``anc`` ``[S, W,
    W]`` is a tree the kernel takes (what ``decode_step_launch`` checks on
    the card): node 0 of each slot the root at depth 0, depths never
    falling with the node index and at most the index, and each node's
    ancestor at a depth below its own an earlier node."""
    dep = depths.to(torch.long).cpu()
    a = anc.to(torch.long).cpu()
    S, W = dep.shape
    if tuple(a.shape) != (S, W, W):
        raise ValueError(f"anc {tuple(a.shape)} does not match depths "
                         f"{tuple(dep.shape)}")
    j = torch.arange(W)
    below = j[None, None, :] < dep[:, :, None]        # [S, W, W]: dd < depth
    if ((dep[:, 0] != 0).any() or (dep < 0).any() or (dep > j).any()
            or (dep[:, 1:] < dep[:, :-1]).any()
            or (below & ((a < 0) | (a >= j[None, :, None]))).any()):
        raise ValueError("depths/anc is not a tree in breadth-first order "
                         "(root first at depth 0, depths non-decreasing, "
                         "ancestors before their nodes)")


def fused_decode_verify_tree_paged_plain(cfg, stacked, x, k_pool, v_pool,
                                         tables, fills, rope, depths, anc,
                                         lora=None):
    """K14's tree mode: node j of slot s runs at ``fills[s] + depths[s,
    j]``, attends the slot's columns ``[0, fill)`` and, at column ``fill +
    dd``, the row of its ancestor ``anc[s, j, dd]`` as a pool round trip
    returns it, then its own row.  Nodes go one after the other over one
    gathered view, each overlaying its root path first, so a chain tree
    (``depths[j] = j``, ``anc[j, dd] = dd``) is the linear window's
    computation.  → K14's outputs, rows in ``s*W + j`` (node) order."""
    S, W, _ = x.shape
    check_tree(depths, anc)
    tables = torch.as_tensor(tables, device=x.device)
    fills = _fills(fills, S, x.device)
    depths = depths.to(device=x.device, dtype=torch.long)
    anc = anc.to(device=x.device, dtype=torch.long)
    ar = torch.arange(S, device=x.device)
    kd, vd = _gather(k_pool, tables, W), _gather(v_pool, tables, W)
    hs, ks, vs = [], [], []
    for j in range(W):
        dj = depths[:, j]
        if j:
            kst, vst = torch.stack(ks, 2), torch.stack(vs, 2)
        for dd in range(j):
            # ancestors below each slot's depth; a slot past its depth
            # writes a column its node never reads (index 0 keeps it valid)
            src = torch.where(dd < dj, anc[:, j, dd], 0)
            _write_rows(kd, kst[:, ar, src], fills + dd)
            _write_rows(vd, vst[:, ar, src], fills + dd)
        hj, kr, vr = _plain_stack(cfg, stacked, x[:, j], kd, vd, fills + dj,
                                  rope, lora)
        hs.append(hj)
        ks.append(kr)
        vs.append(vr)

    def rows(parts):
        r = torch.stack(parts, dim=2)                # [L, S, W, kv, 1, d]
        return r.reshape((r.shape[0], S * W) + tuple(r.shape[3:]))

    return torch.stack(hs, dim=1), rows(ks), rows(vs)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The bf16 body's weight stream (csrc/decode_step.cu, ``Geo``): tiles of
# 1 KB of a stored row, stages of 16 stored rows, eight to an item
KERNEL_ROW_BYTES = 1024
KERNEL_STAGE_ROWS = 16
KERNEL_STAGES_PER_ITEM = 8


def gemv_plan(cfg, aq: int, mq: int) -> list:
    """The four GEMV phases of a layer as the bf16 body cuts them (q/k/v,
    wo, gate/up, w_down; the kernel's ``geo``): per phase a dict of the
    matrices' widths ``N``, the tile width ``cols`` (1 KB of a stored row:
    512 bf16 columns, 1024 int8 / int4; a matrix's last tile may be
    ragged), the contraction ``K``, its segments (w_down's ``mlp_chunks``,
    added to the residual in turn) of ``kseg`` rows cut into chunks of
    ``ci`` rows (128 stored rows; the last of a segment may be short), and
    the counts ``ntiles``, ``nch`` (chunks a tile) and ``items`` (tile x
    chunk, numbered tile-major)."""
    h, ffn = cfg.hidden_size, cfg.ffn_size
    nqd = cfg.num_attention_heads * cfg.head_dim
    nkvd = cfg.kv_heads * cfg.head_dim
    out = []
    for kind, K, N, nseg in ((aq, h, (nqd, nkvd, nkvd), 1),
                             (aq, nqd, (h,), 1),
                             (mq, h, (ffn, ffn), 1),
                             (mq, ffn, (h,), mlp_chunks(ffn))):
        cols = KERNEL_ROW_BYTES if kind else KERNEL_ROW_BYTES // 2
        rps = KERNEL_STAGE_ROWS * (2 if kind == 4 else 1)
        ci = KERNEL_STAGES_PER_ITEM * rps
        kseg = K // nseg
        cps = -(-kseg // ci)
        ntiles = sum(-(-n // cols) for n in N)
        out.append(dict(N=N, cols=cols, K=K, kseg=kseg, ci=ci, cps=cps,
                        nch=nseg * cps, ntiles=ntiles,
                        items=ntiles * nseg * cps))
    return out


def gemv_item(ph: dict, it: int) -> dict:
    """Item ``it`` of a phase of ``gemv_plan``: its tile ``t`` (matrix
    ``m``, first column ``n0``), chunk ``c`` and contraction rows ``[k0,
    k1)`` (the kernel's ``item_of``)."""
    t, c = divmod(it, ph["nch"])
    seg, cc = divmod(c, ph["cps"])
    k0 = seg * ph["kseg"] + cc * ph["ci"]
    k1 = min(k0 + ph["ci"], (seg + 1) * ph["kseg"])
    m, first = 0, 0
    for m, n in enumerate(ph["N"]):
        tiles = -(-n // ph["cols"])
        if t < first + tiles:
            break
        first += tiles
    return dict(t=t, c=c, m=m, n0=(t - first) * ph["cols"], k0=k0, k1=k1)


def gemv_block_items(ph: dict, block: int, grid: int) -> range:
    """The items block ``block`` of ``grid`` takes, in order: every
    ``grid``-th from its own index (item ``it`` is at position ``it //
    grid`` of its block)."""
    return range(block, ph["items"], grid)


class _Args(ctypes.Structure):
    """``Args`` of csrc/decode_step.cu, field for field."""
    _fields_ = [
        ("x", _P), ("hidden", _P), ("c_rows", _P), ("s_rows", _P),
        ("nw1", _P), ("nw2", _P), ("w", _P * 7), ("ws", _P * 7),
        ("kc", _P), ("vc", _P), ("kcs", _P), ("vcs", _P),
        ("tables", _P), ("fills", _P), ("depths", _P), ("anc", _P),
        ("k_rows", _P), ("v_rows", _P),
        ("res", _P), ("q", _P), ("kn", _P), ("vn", _P), ("ctx", _P),
        ("gate", _P), ("up", _P), ("bar", _P),
        ("la", _P * 7), ("lb", _P * 7), ("lmask", _P), ("lpart", _P),
        ("gpart", _P),
        ("L", _I), ("rows", _I), ("W", _I), ("h", _I), ("nq", _I),
        ("nkv", _I), ("d", _I), ("ffn", _I), ("nm", _I), ("aq", _I),
        ("mq", _I), ("gsz", _I), ("act", _I), ("paged", _I), ("n_ent", _I),
        ("width", _I), ("shift", _I), ("n_tbl", _I), ("lsr", _I),
        ("lch", _I), ("gcap", _I),
        ("eps", _F), ("scale", _F),
    ]


_WEIGHTS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
            ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


def _ptr(t: Optional[torch.Tensor], name: str, what: str) -> Optional[int]:
    if t is None:
        return None
    if not (t.is_cuda and t.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous CUDA tensor")
    return t.data_ptr()


def _set_lora(a: "_Args", name: str, cfg, lora, rows: int, L: int,
              device) -> list:
    """Point ``a`` at a LoRA bundle ``(arenas, [rows, Sr] mask)`` after
    checking the arenas (the mask's shape: ``_check_lora``), and allocate
    the x·A partial sums; → the tensors the launch must keep alive."""
    from ..ops.lora import lora_target_shapes

    arenas, mask = lora
    lsr = arena_sr(arenas)
    if not lsr or not lora_fits(lsr):
        raise ValueError(f"{name}: the kernel takes a LoRA arena of "
                         f"{KERNEL_TILE}-column tiles up to "
                         f"{KERNEL_MAX_LORA_SR} columns, got {lsr}")
    mask = mask.to(torch.float32).contiguous()   # [rows, lsr]: _check_lora
    shapes = lora_target_shapes(cfg)
    for i, t in enumerate(LORA_TARGETS):
        if t not in arenas:
            continue
        fin, fout = shapes[t]
        fa, fb = arenas[t]["a"], arenas[t]["b"]
        if fa.dtype != torch.float32 or fb.dtype != torch.float32 \
                or tuple(fa.shape) != (L, fin, lsr) \
                or tuple(fb.shape) != (L, lsr, fout):
            raise ValueError(f"{name}: LoRA arena {t} must be fp32 "
                             f"[{L}, {fin}, {lsr}] / [{L}, {lsr}, {fout}]")
        a.la[i] = _ptr(fa, name, f"LoRA {t}.a")
        a.lb[i] = _ptr(fb, name, f"LoRA {t}.b")
    lch = -(-max(shapes.values(), key=lambda io: io[0])[0]
            // KERNEL_LORA_CHUNK)
    lpart = torch.empty(7 * lch * rows * lsr, dtype=torch.float32,
                        device=device)
    a.lmask, a.lpart = _ptr(mask, name, "LoRA mask"), lpart.data_ptr()
    a.lsr, a.lch = lsr, lch
    return [mask, lpart]


def _launch(name: str, cfg, stacked, x, k, v, tables, fills, W: int, rope,
            depths=None, anc=None, lora=None):
    """One cooperative launch over ``x`` ``[rows, h]`` (rows = slots x
    W).  ``tables`` None reads a dense cache whose batch row is the row;
    ``fills`` ``[S]`` are the slots' committed fills; ``depths``/``anc``
    make the window a tree (the kernel checks it, and refuses a bad one);
    ``lora`` is ``(arenas, [rows, Sr] mask)``."""
    a, outs, keep = _prepare(name, cfg, stacked, x, k, v, tables, fills, W,
                             rope, depths, anc, lora)
    fn = build.load("decode_step").decode_step_launch
    if fn.argtypes is None:
        # args dtype int8_cache stream; the body launched (out)
        fn.argtypes = [_P, _I, _I, _P, _P]
        fn.restype = _I
    body = ctypes.c_int(-1)
    err = fn(ctypes.addressof(a), _DTYPE_CODES[x.dtype],
             int(is_quantized_cache(k)),
             torch.cuda.current_stream(x.device).cuda_stream,
             ctypes.byref(body))
    build.check(err, name)
    del keep  # scratch, the tables, the LoRA mask: alive until the launch
    return outs, body.value == _BODY_TMA


def _prepare(name: str, cfg, stacked, x, k, v, tables, fills, W: int, rope,
             depths=None, anc=None, lora=None):
    """``(Args, (hidden, k_rows, v_rows), tensors the launch reads)`` of
    ``_launch``'s call, after its checks (``kernels/decode_probe.py``
    launches the same Args through its stamped build)."""
    rows, h = x.shape
    elig = _stack_form(cfg, {"layers": stacked})
    cq8 = is_quantized_cache(k)
    kc = _leaf(k)
    if x.dtype not in _DTYPE_CODES or x.dtype != cfg.dtype or elig is None \
            or not _cache_fits(cfg, k) or rows > KERNEL_MAX_ROWS \
            or W > KERNEL_MAX_WINDOW or h != cfg.hidden_size:
        raise ValueError(
            f"{name}: the kernel takes an RMSNorm GLU rotary stack without "
            f"biases (uniform weight classes), head dim {KERNEL_HEAD_DIMS}, "
            f"a GQA group <= {KERNEL_MAX_GROUP}, widths in "
            f"{KERNEL_TILE}-column tiles, x in the model's fp32/bf16, a "
            f"cache in that dtype or int8, <= {KERNEL_MAX_ROWS} rows and a "
            f"window <= {KERNEL_MAX_WINDOW}; got x {x.dtype} "
            f"{tuple(x.shape)}, cache {kc.dtype} {tuple(kc.shape)}")
    aq, mq, gsz = elig
    L, n_ent, nkv, width, d = kc.shape
    if nkv != cfg.kv_heads or d != cfg.head_dim:
        raise ValueError(f"{name}: cache {tuple(kc.shape)} does not match "
                         "the config's heads")
    paged = tables is not None
    shift = 0
    if paged:
        if width < KERNEL_MIN_BLOCK or width & (width - 1):
            raise ValueError(f"{name}: the pool block must be a power of "
                             f"two from {KERNEL_MIN_BLOCK}, got {width}")
        shift = width.bit_length() - 1
        tables = tables.to(torch.int32).contiguous()
    elif n_ent != rows:
        raise ValueError(f"{name}: a dense cache needs one batch row per "
                         f"row, got {n_ent} for {rows}")
    S = rows // W
    fills = fills.to(torch.int32).reshape(-1).expand(S).contiguous()
    if depths is not None:
        depths = depths.to(device=x.device, dtype=torch.int32).contiguous()
        anc = anc.to(device=x.device, dtype=torch.int32).contiguous()
        if depths.shape != (S, W) or anc.shape != (S, W, W):
            raise ValueError(f"{name}: depths {tuple(depths.shape)} / anc "
                             f"{tuple(anc.shape)} for {S} slots of {W}")
        off = depths.to(torch.long)
    else:
        off = torch.arange(W, device=x.device)[None, :]
    pos = (fills[:, None].to(torch.long) + off).reshape(-1)
    c_rows, s_rows = rope_rows(rope, pos, d)
    nq, ffn = cfg.num_attention_heads, cfg.ffn_size
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = {"res": torch.empty(rows, h, **f32),
               "q": torch.empty(rows, nq * d, **f32),
               "kn": torch.empty(rows, nkv * d, **f32),
               "vn": torch.empty(rows, nkv * d, **f32),
               "ctx": torch.empty(rows, nq * d, **f32),
               "gate": torch.empty(rows, ffn, **f32),
               "up": torch.empty(rows, ffn, **f32),
               "bar": torch.empty(1, dtype=torch.int32, device=x.device)}
    hidden = torch.empty_like(x)
    row_dt = torch.float32 if cq8 else kc.dtype
    k_rows = torch.empty((L, rows, nkv, d), dtype=row_dt, device=x.device)
    v_rows = torch.empty_like(k_rows)
    a = _Args()
    a.x, a.hidden = _ptr(x, name, "x"), hidden.data_ptr()
    a.c_rows, a.s_rows = c_rows.data_ptr(), s_rows.data_ptr()
    a.nw1 = _ptr(stacked["input_norm"]["scale"], name, "input_norm")
    a.nw2 = _ptr(stacked["post_attn_norm"]["scale"], name, "post_attn_norm")
    if stacked["input_norm"]["scale"].dtype != x.dtype \
            or stacked["post_attn_norm"]["scale"].dtype != x.dtype:
        raise ValueError(f"{name}: norm scales must be in x's dtype")
    for i, (grp, wname) in enumerate(_WEIGHTS):
        w = stacked[grp][wname]
        a.w[i] = _ptr(w["q"] if is_quantized(w) else w, name, wname)
        a.ws[i] = _ptr(w["scale"], name, wname + " scale") \
            if is_quantized(w) else None
    a.kc, a.vc = _ptr(kc, name, "k cache"), _ptr(_leaf(v), name, "v cache")
    if cq8:
        a.kcs = _ptr(k["scale"], name, "k scales")
        a.vcs = _ptr(v["scale"], name, "v scales")
    a.tables = tables.data_ptr() if paged else None
    a.fills = fills.data_ptr()
    if depths is not None:
        a.depths, a.anc = depths.data_ptr(), anc.data_ptr()
    a.k_rows, a.v_rows = k_rows.data_ptr(), v_rows.data_ptr()
    for key, t in scratch.items():
        setattr(a, key, t.data_ptr())  # (gpart comes below)
    a.L, a.rows, a.W, a.h, a.nq, a.nkv, a.d = L, rows, W, h, nq, nkv, d
    a.ffn, a.nm, a.aq, a.mq, a.gsz = ffn, mlp_chunks(ffn), aq, mq, gsz
    a.act = _ACT_CODES[cfg.activation]
    a.paged, a.n_ent, a.width, a.shift = int(paged), n_ent, width, shift
    a.n_tbl = tables.shape[1] if paged else 0
    a.eps, a.scale = float(cfg.norm_eps), 1.0 / math.sqrt(d)
    if x.dtype == torch.bfloat16:
        # the bf16 body's chunk partials
        a.gcap = max(p["nch"] * rows * p["ntiles"] * p["cols"]
                     for p in gemv_plan(cfg, aq, mq))
        scratch["gpart"] = torch.empty(a.gcap, **f32)
        a.gpart = scratch["gpart"].data_ptr()
    keep = [scratch, tables, fills, depths, anc, c_rows, s_rows]
    if lora is not None:
        keep += _set_lora(a, name, cfg, lora, rows, L, x.device)
    return a, (hidden, k_rows[:, :, :, None, :],
               v_rows[:, :, :, None, :]), keep


def _check_lora(name: str, lora, rows: int) -> None:
    """Raise unless ``lora`` is None or ``(arenas, mask)`` with a mask
    ``[rows, Sr]`` over arenas of stacked rank Sr (both routes)."""
    if lora is None:
        return
    arenas, mask = lora
    lsr = arena_sr(arenas)
    if not lsr or tuple(mask.shape) != (rows, lsr):
        raise ValueError(f"{name}: LoRA mask {tuple(mask.shape)} for {rows} "
                         f"rows of an arena of {lsr} columns")


def _count(fn, lora, tma: bool) -> None:
    """One launch of ``fn``'s kernel: with an arena on ``fn.lora``; a
    launch the C launcher reports on the TMA body also in
    ``tma_launches``."""
    c = fn if lora is None else fn.lora
    c.launches += 1
    c.tma_launches += tma


def _window_lora(lora, W: int):
    """A per-slot LoRA mask repeated over each slot's W window rows."""
    if lora is None:
        return None
    return lora[0], torch.repeat_interleave(lora[1], W, dim=0)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def fused_decode_step(cfg, stacked, x, k_cache, v_cache, cache_len, rope, *,
                      lora=None):
    """K12 → ``(hidden [b, h], k_rows [L, b, kv, 1, d], v_rows)``.

    ``x`` is the embedded new token of each row, ``k_cache``/``v_cache``
    ``[L, b, kv, max_len, d]`` (or the int8 form) not yet updated,
    ``cache_len`` a scalar or ``[b]`` fill (the new token's position).  The
    caller writes the rows at ``cache_len`` (``ops/kv_quant.cache_update``).
    ``lora``: ``(arenas, [b, Sr] mask)``.  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_lora("fused_decode_step", lora, x.shape[0])
    if x.device.type == "cpu":
        return fused_decode_step_plain(cfg, stacked, x, k_cache, v_cache,
                                       cache_len, rope, lora)
    out, tma = _launch("fused_decode_step", cfg, stacked, x, k_cache,
                       v_cache, None, _fills(cache_len, x.shape[0], x.device),
                       1, rope, lora=lora)
    _count(fused_decode_step, lora, tma)
    return out


def fused_decode_step_paged(cfg, stacked, x, k_pool, v_pool, tables, fills,
                            rope, *, lora=None):
    """K13 → K12's outputs, the cache read from the pool ``[L, n_blocks,
    kv, block, d]`` through ``tables`` ``[b, T]`` at per-slot ``fills``
    ``[b]`` (free slots at 0 over the trash block).  The caller appends
    the rows at ``tables[s, fill // block]``, ``fill % block``.  ``lora``:
    ``(arenas, [b, Sr] mask)``."""
    _check_lora("fused_decode_step_paged", lora, x.shape[0])
    if x.device.type == "cpu":
        return fused_decode_step_paged_plain(cfg, stacked, x, k_pool, v_pool,
                                             tables, fills, rope, lora)
    out, tma = _launch("fused_decode_step_paged", cfg, stacked, x, k_pool,
                       v_pool, torch.as_tensor(tables, device=x.device),
                       _fills(fills, x.shape[0], x.device), 1, rope,
                       lora=lora)
    _count(fused_decode_step_paged, lora, tma)
    return out


def fused_decode_verify_paged(cfg, stacked, x, k_pool, v_pool, tables,
                              fills, rope, *, depths=None, anc=None,
                              lora=None):
    """K14 → ``(hidden [S, W, h], k_rows [L, S*W, kv, 1, d], v_rows)``:
    row (s, j) of ``x`` ``[S, W, h]`` is slot s's token at position
    ``fills[s] + j``; the rows come back in ``s*W + j`` order.  Each
    position is bitwise what W sequential ``fused_decode_step_paged``
    calls with the host's pool writes between them give.  With
    ``depths``/``anc`` the window is a tree
    (``fused_decode_verify_tree_paged``).  ``lora``: ``(arenas, [S, Sr]
    mask)``, each slot's row of the mask over its whole window."""
    _check_lora("fused_decode_verify_paged", lora, x.shape[0])
    if depths is not None or anc is not None:
        return fused_decode_verify_tree_paged(
            cfg, stacked, x, k_pool, v_pool, tables, fills, rope, depths, anc,
            lora=lora)
    if x.device.type == "cpu":
        return fused_decode_verify_paged_plain(cfg, stacked, x, k_pool,
                                               v_pool, tables, fills, rope,
                                               lora)
    S, W, h = x.shape
    (hidden, k_rows, v_rows), tma = _launch(
        "fused_decode_verify_paged", cfg, stacked, x.reshape(S * W, h),
        k_pool, v_pool, torch.as_tensor(tables, device=x.device),
        _fills(fills, S, x.device), W, rope, lora=_window_lora(lora, W))
    _count(fused_decode_verify_paged, lora, tma)
    return hidden.reshape(S, W, h), k_rows, v_rows


def fused_decode_verify_tree_paged(cfg, stacked, x, k_pool, v_pool, tables,
                                   fills, rope, depths, anc, *, lora=None):
    """K14's tree mode → K14's outputs.  Window column j of slot s is a
    tree node at depth ``depths[s, j]`` ``[S, W]`` whose ancestor at depth
    ``dd`` is node ``anc[s, j, dd]`` ``[S, W, W]`` (entries at or past the
    node's depth are ignored); nodes are in breadth-first order (the root,
    the slot's pending token, first).  Node j runs at ``fills[s] +
    depths[s, j]`` and attends the slot's cache plus its root path, so
    each node is bitwise what sequential ``fused_decode_step_paged`` calls
    down that path give; the rows come back node-indexed and the caller
    compacts the accepted path (``models/model.cache_move_rows``).
    ``lora``: ``(arenas, [S, Sr] mask)``, per slot as K14's."""
    _check_lora("fused_decode_verify_tree_paged", lora, x.shape[0])
    if x.device.type == "cpu":
        return fused_decode_verify_tree_paged_plain(
            cfg, stacked, x, k_pool, v_pool, tables, fills, rope, depths, anc,
            lora)
    S, W, h = x.shape
    (hidden, k_rows, v_rows), tma = _launch(
        "fused_decode_verify_tree_paged", cfg, stacked, x.reshape(S * W, h),
        k_pool, v_pool, torch.as_tensor(tables, device=x.device),
        _fills(fills, S, x.device), W, rope, depths=torch.as_tensor(depths),
        anc=torch.as_tensor(anc), lora=_window_lora(lora, W))
    _count(fused_decode_verify_tree_paged, lora, tma)
    return hidden.reshape(S, W, h), k_rows, v_rows


for _fn in (fused_decode_step, fused_decode_step_paged,
            fused_decode_verify_paged, fused_decode_verify_tree_paged):
    _fn.launches = 0
    _fn.tma_launches = 0
    _fn.lora = types.SimpleNamespace(launches=0, tma_launches=0)
del _fn
