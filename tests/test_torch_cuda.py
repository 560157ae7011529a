"""The hand-written kernels on the card, each against its plain version,
and the model and train step through them against the CPU's plain path.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX (the machine with the card has none), so it runs there
on its own, without the suite's JAX conftest::

    pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from megatron_llm_tpu_torch.config import tiny_config
from megatron_llm_tpu_torch.kernels import flash_attention as tfa
from megatron_llm_tpu_torch.kernels import flash_decode as tfd
from megatron_llm_tpu_torch.kernels import launch_counters
from megatron_llm_tpu_torch.kernels import rmsnorm as trn
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.ops import attention as tattn
from megatron_llm_tpu_torch.ops import kv_quant as tkv
from megatron_llm_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

# bf16 outputs of fp32 math: the kernel and the plain version each round
# the result to bf16 once (2^-8 relative), and their fp32 sums run in
# another order; 2^-6 relative allows two rounding steps
CARD_TOL = dict(rtol=2 ** -6, atol=2e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card(shape, gen, dev, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hk,sq,sk,segs,dtype", [
    (8, 8, 200, 200, False, torch.bfloat16),
    (8, 2, 77, 300, False, torch.bfloat16),     # causal offset, GQA, ragged
    (4, 4, 256, 256, True, torch.bfloat16),     # segment ids
    (4, 1, 130, 130, False, torch.float32)])    # MQA, fp32
def test_flash_attention_matches_plain(cuda_device, hq, hk, sq, sk, segs,
                                       dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = _card((2, sq, hq, 128), gen, cuda_device, dtype)
    k = _card((2, sk, hk, 128), gen, cuda_device, dtype)
    v = _card((2, sk, hk, 128), gen, cuda_device, dtype)
    seg = None
    if segs:
        seg = (torch.arange(sq, device=cuda_device) // 50).repeat(2, 1)
        seg = seg.to(torch.int32).contiguous()
    before = tfa.flash_attention_fwd.launches
    mma = tfa.flash_attention_fwd.mma_launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    # bf16 takes the tensor-core body, fp32 the CUDA-core one
    assert tfa.flash_attention_fwd.mma_launches == mma + (
        dtype != torch.float32)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, causal=True,
                                               segment_ids=seg)
    # fp32 inputs: only the order of fp32 sums differs
    tol = CARD_TOL if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(o.float(), o_ref.float(), **tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hk,sq,sk,d,causal,segs,dtype", [
    (1, 4, 2, 100, 300, 64, True, False, torch.bfloat16),   # d 64, ragged
    (2, 4, 4, 300, 70, 128, True, False, torch.bfloat16),   # rows no key
    (1, 8, 1, 129, 129, 64, False, False, torch.bfloat16),  # not causal
    (2, 4, 2, 200, 200, 128, True, True, torch.float16),    # fp16, segs
    (1, 4, 4, 65, 193, 64, True, False, torch.float16),     # fp16, d 64
])
def test_flash_attention_mma_edges_match_plain(cuda_device, b, hq, hk, sq,
                                               sk, d, causal, segs, dtype):
    """K1's tensor-core body where its tiles meet the edges: q and k
    lengths off the 64-row tile, rows that see no key, head dim 64, fp16;
    within CARD_TOL of the plain version, which rounds P where it does."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, _, seg = _bwd_inputs(gen, cuda_device, b, sq, sk, hq, hk, d,
                                  dtype, segs)
    mma = tfa.flash_attention_fwd.mma_launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.mma_launches == mma + 1
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, causal=causal,
                                               segment_ids=seg)
    assert o.dtype == dtype and torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), o_ref.float(), **CARD_TOL)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    if causal and sq > sk:  # rows that see no key
        assert not o[:, :sq - sk].any()
        assert (lse[:, :, :sq - sk] == tfa.NO_KEY_LSE).all()


# fills: 0 (the mean of V over the width), one split, the split boundary
# and one past it (two splits), the whole width
DECODE_FILLS = [0, 129, tfd.SPLIT_COLS - 1, tfd.SPLIT_COLS,
                tfd.SPLIT_COLS + 1, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("nq,kv,d", [(32, 32, 128), (32, 8, 128), (8, 1, 128),
                                     (4, 2, 64), (64, 8, 128)])
def test_flash_decode_matches_plain(cuda_device, nq, kv, d):
    b = len(DECODE_FILLS)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = _card((b, nq, d), gen, cuda_device)
    kc = _card((b, kv, 512, d), gen, cuda_device)
    vc = _card((b, kv, 512, d), gen, cuda_device)
    lens = torch.tensor(DECODE_FILLS, dtype=torch.int32, device=cuda_device)
    before = tfd.flash_decode.launches
    out = tfd.flash_decode(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == before + 1
    torch.testing.assert_close(out.float(),
                               tfd.flash_decode_plain(q, kc, vc, lens).float(),
                               **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", [(37, 4096), (1, 64), (300, 5120)])
def test_rmsnorm_matches_plain(cuda_device, rows, h):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = _card((rows, h), gen, cuda_device)
    w = _card((h,), gen, cuda_device)
    y, rstd = trn.rmsnorm_fwd(x, w, 1e-5)
    y_ref, rstd_ref = trn.rmsnorm_plain(x, w, 1e-5)
    torch.testing.assert_close(y.float(), y_ref.float(), **CARD_TOL)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", [(37, 4544), (1, 64), (300, 2048)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_fwd_bwd_match_plain(cuda_device, rows, h, bias, dtype):
    """K6 and K7 against their plain versions: Falcon-7B's hidden 4544 (a
    block of 8192 lanes, 3648 of them masked), a one-row call and GPT-1.3B's
    2048, with and without bias.  K7 returns dx, dweight and dbias from its
    own launches (one counted call), the same bits on a second call."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = (2.0 * _card((rows, h), gen, cuda_device, torch.float32)
         + 0.5).to(dtype)
    w = (1.0 + 0.1 * _card((h,), gen, cuda_device, torch.float32)).to(dtype)
    b = (0.1 * _card((h,), gen, cuda_device, torch.float32)).to(dtype) \
        if bias else None
    dy = _card((rows, h), gen, cuda_device, dtype)
    n_fwd, n_bwd = trn.layernorm_fwd.launches, trn.layernorm_bwd.launches
    y, mean, rstd = trn.layernorm_fwd(x, w, b, 1e-5)
    got = trn.layernorm_bwd(x, w, mean, rstd, dy, has_bias=bias)
    again = trn.layernorm_bwd(x, w, mean, rstd, dy, has_bias=bias)
    torch.cuda.synchronize()
    assert trn.layernorm_fwd.launches == n_fwd + 1
    assert trn.layernorm_bwd.launches == n_bwd + 2
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)
    y_ref, mean_ref, rstd_ref = trn.layernorm_plain(x, w, b, 1e-5)
    want = trn.layernorm_bwd_plain(x, w, mean, rstd, dy, has_bias=bias)
    # fp32: only the order of the fp32 row sums differs
    tol = CARD_TOL if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    torch.testing.assert_close(mean, mean_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0.0)
    assert (got[2] is None) == (not bias)
    for g, r in zip(got, want):
        if r is not None:
            torch.testing.assert_close(g.float(), r.float(), **tol)


@pytest.mark.cuda
def test_flash_attention_at_falcon_shape(cuda_device):
    """K1, K2 and K3 at Falcon-7B's attention: 71 query heads over one KV
    head (a group that is not a power of two), head dim 64, causal, bf16,
    against the plain versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do, _ = _bwd_inputs(gen, cuda_device, 1, 512, 512, 71, 1, 64,
                                 torch.bfloat16, False)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), **CARD_TOL)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    # dK and dV sum 71 heads x 512 rows of O(1) products
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=2 ** -6,
                                   atol=5e-2, msg=name)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = _card((1, 16, 2, 96), gen, cuda_device)     # head dim 96
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q, q)
    x = _card((4, 64, 2, 128), gen, cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(x, x, x)             # not contiguous
    with pytest.raises(TypeError):
        trn.rmsnorm_fwd(_card((4, 64), gen, cuda_device, torch.float64),
                        _card((64,), gen, cuda_device))
    qd = _card((2, 4, 128), gen, cuda_device)
    kd = _card((2, 4, 64, 128), gen, cuda_device, torch.float32)
    with pytest.raises(ValueError):
        tfd.flash_decode(qd, kd, kd, 3)              # mixed dtypes


@pytest.mark.cuda
def test_model_path_on_the_card_matches_cpu(cuda_device):
    """A prefill and paged decode steps of a small fp32 model (head dim
    128) through the three kernels on the card, against the same model's
    plain path on the CPU."""
    cfg = tiny_config(hidden_size=256, num_attention_heads=2, num_kv_heads=1,
                      ffn_hidden_size=512, attention_impl="flash",
                      norm_impl="pallas", fused_decode=False)
    params = tm.init_params(cfg, seed=0, device="cpu")

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(0))
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        p = to(params, dev)
        k, v = tm.init_kv_cache(cfg, 1, 32, device=dev)
        pre, k, v = tm.forward_cached(cfg, p, toks[:, :20].to(dev), k, v, 0,
                                      empty_cache=True)
        k_pool, v_pool = tm.init_kv_pool(cfg, 5, 8, device=dev)
        bids = torch.arange(1, 5, device=dev)
        tm.cache_scatter_blocks(k_pool, k, bids)
        tm.cache_scatter_blocks(v_pool, v, bids)
        steps = [pre[:, -1]]
        for i in range(4):
            lg, _, _ = tm.forward_cached_paged(
                cfg, p, toks[:, 20 + i:21 + i].to(dev), k_pool, v_pool,
                bids[None], torch.tensor([20 + i], device=dev))
            steps.append(lg[:, 0])
        outs[dev.type] = torch.cat(steps).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)
    launches = {n: fn.launches for n, fn in counters.items()}
    assert launches == {"flash_attention_fwd": cfg.num_layers,
                        "flash_attention_fwd_mma": 0,   # fp32: CUDA cores
                        "flash_attention_bwd_dq": 0,
                        "flash_attention_bwd_dq_mma": 0,
                        "flash_attention_bwd_dkv": 0,
                        "flash_attention_bwd_dkv_mma": 0,
                        "flash_decode": 4 * cfg.num_layers,
                        "flash_decode_int8": 0, "flash_decode_paged": 0,
                        "flash_decode_paged_int8": 0,
                        "flash_decode_split": 4 * cfg.num_layers,
                        "flash_decode_int8_split": 0,
                        "flash_decode_paged_split": 0,
                        "flash_decode_paged_int8_split": 0,
                        "rmsnorm_fwd": 5 * (2 * cfg.num_layers + 1),
                        "rmsnorm_bwd": 0, "layernorm_fwd": 0,
                        "layernorm_bwd": 0, "fused_decode_step": 0,
                        "fused_decode_step_paged": 0,
                        "fused_decode_verify_paged": 0,
                        "fused_decode_verify_tree_paged": 0,
                        "fused_decode_step_lora": 0,
                        "fused_decode_step_paged_lora": 0,
                        "fused_decode_verify_paged_lora": 0,
                        "fused_decode_verify_tree_paged_lora": 0,
                        "fused_decode_step_tma": 0,
                        "fused_decode_step_lora_tma": 0,
                        "fused_decode_step_paged_tma": 0,
                        "fused_decode_step_paged_lora_tma": 0,
                        "fused_decode_verify_paged_tma": 0,
                        "fused_decode_verify_paged_lora_tma": 0,
                        "fused_decode_verify_tree_paged_tma": 0,
                        "fused_decode_verify_tree_paged_lora_tma": 0}, \
        launches


def _bwd_inputs(gen, dev, b, sq, sk, hq, hk, d, dtype, segs):
    q = _card((b, sq, hq, d), gen, dev, dtype)
    k = _card((b, sk, hk, d), gen, dev, dtype)
    v = _card((b, sk, hk, d), gen, dev, dtype)
    do = _card((b, sq, hq, d), gen, dev, dtype)
    seg = None
    if segs:
        seg = (torch.arange(sq, device=dev) // 50).repeat(b, 1)
        seg = seg.to(torch.int32).contiguous()
    return q, k, v, do, seg


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hk,sq,sk,d,causal,segs,dtype", [
    (8, 8, 200, 200, 128, True, False, torch.bfloat16),
    (8, 2, 77, 300, 128, True, False, torch.bfloat16),   # offset, GQA, ragged
    (4, 4, 256, 256, 128, True, True, torch.bfloat16),   # segment ids
    (4, 1, 130, 130, 64, False, False, torch.float32),   # MQA, d 64, fp32
    (4, 2, 300, 70, 128, True, False, torch.float32)])   # rows with no key
def test_flash_attention_bwd_matches_plain(cuda_device, hq, hk, sq, sk, d,
                                           causal, segs, dtype):
    """K2 (dQ) and K3 (dK, dV) against ``flash_attention_bwd_plain`` on the
    forward kernel's own O and lse."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, do, seg = _bwd_inputs(gen, cuda_device, 2, sq, sk, hq, hk, d,
                                   dtype, segs)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    n_dq = tfa.flash_attention_bwd_dq.launches
    n_dkv = tfa.flash_attention_bwd_dkv.launches
    n_mma = tfa.flash_attention_bwd_dkv.mma_launches
    n_dq_mma = tfa.flash_attention_bwd_dq.mma_launches
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  segment_ids=seg)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dq.launches == n_dq + 1
    assert tfa.flash_attention_bwd_dkv.launches == n_dkv + 1
    assert tfa.flash_attention_bwd_dkv.mma_launches == n_mma + (
        dtype != torch.float32)
    assert tfa.flash_attention_bwd_dq.mma_launches == n_dq_mma + (
        dtype != torch.float32)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         segment_ids=seg)
    # grads are sums over up to sk (dQ) or group * sq (dK, dV) terms of
    # O(1) products: bf16 rounds the result once on each side; fp32 only
    # reorders the sums.  dQ, dK and dV (K2's and K3's tensor-core bodies)
    # round P and dS where the plain version does: CARD_TOL
    tol = CARD_TOL if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=name)
    if sq > sk:  # causal rows that see no key get dQ = 0 exactly
        assert not got[0][:, :sq - sk].any()


def _dkv(q, k, v, do, causal, seg, splits=None):
    """K3 alone on the forward kernel's lse, and the plain (dK, dV)."""
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                      segment_ids=seg, splits=splits)
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd_dkv_plain(q, k, v, o, lse, do,
                                             causal=causal, segment_ids=seg)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hk,sq,sk,d,causal,segs,dtype", [
    (1, 8, 2, 100, 300, 64, True, False, torch.bfloat16),   # d 64, ragged
    (2, 4, 4, 300, 70, 128, True, False, torch.bfloat16),   # rows no key
    (1, 4, 1, 129, 129, 64, False, False, torch.bfloat16),  # not causal
    (2, 4, 2, 200, 200, 128, True, True, torch.float16),    # fp16, segs
    (1, 8, 1, 256, 256, 128, True, False, torch.bfloat16),  # split grid
    (1, 8, 1, 65, 193, 64, True, False, torch.float16),     # fp16, split
])
def test_flash_attention_dkv_mma_edges_match_plain(cuda_device, b, hq, hk,
                                                   sq, sk, d, causal, segs,
                                                   dtype):
    """K3's tensor-core body where its tiles meet the edges (q and k
    lengths off the 64-row tile, key tiles no row sees, head dim 64, fp16)
    and with its walk split over several blocks (one kv head: a grid of
    a few blocks), within CARD_TOL of the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, do, seg = _bwd_inputs(gen, cuda_device, b, sq, sk, hq, hk, d,
                                   dtype, segs)
    n_mma = tfa.flash_attention_bwd_dkv.mma_launches
    got, want = _dkv(q, k, v, do, causal, seg)
    assert tfa.flash_attention_bwd_dkv.mma_launches == n_mma + 1
    for name, g, w in zip(("dk", "dv"), got, want):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), **CARD_TOL,
                                   msg=name)


@pytest.mark.cuda
def test_flash_attention_dkv_split_equals_unsplit_and_repeats(cuda_device):
    """A small grid (one kv head, group 8, 4 key tiles) splits K3's walk:
    the split result is within CARD_TOL of the unsplit one (its fp32
    partials are summed in another order), and two runs on the same inputs
    are equal bit for bit (no atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, do, _ = _bwd_inputs(gen, cuda_device, 1, 256, 256, 8, 1, 128,
                                 torch.bfloat16, False)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits = tfa._dkv_splits(1, 1, 256, 8, sms)
    assert splits > 1
    split, want = _dkv(q, k, v, do, True, None)
    again, _ = _dkv(q, k, v, do, True, None)
    unsplit, _ = _dkv(q, k, v, do, True, None, splits=1)
    forced, _ = _dkv(q, k, v, do, True, None, splits=3)
    for i, name in enumerate(("dk", "dv")):
        assert torch.equal(split[i], again[i]), name
        for g in (split[i], forced[i]):
            torch.testing.assert_close(g.float(), unsplit[i].float(),
                                       **CARD_TOL, msg=name)
            torch.testing.assert_close(g.float(), want[i].float(),
                                       **CARD_TOL, msg=name)


def _dq(q, k, v, do, causal, seg):
    """K2 alone on the forward kernel's lse, and the plain dQ."""
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                     segment_ids=seg)
    again = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                       causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                            causal=causal, segment_ids=seg)
    return got, again, want


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hk,sq,sk,d,causal,segs,dtype", [
    (1, 8, 2, 100, 300, 64, True, False, torch.bfloat16),   # d 64, ragged
    (2, 4, 4, 300, 70, 128, True, False, torch.bfloat16),   # rows no key
    (1, 4, 1, 129, 129, 64, False, False, torch.bfloat16),  # MQA, not causal
    (2, 4, 2, 200, 200, 128, True, True, torch.float16),    # fp16, segs
    (2, 8, 8, 256, 256, 128, False, True, torch.bfloat16),  # segs, no mask
    (1, 32, 8, 512, 512, 128, True, False, torch.bfloat16),  # GQA 4
    (1, 71, 1, 193, 193, 64, True, False, torch.bfloat16),  # MQA 71 (Falcon)
    (1, 4, 2, 65, 193, 64, True, False, torch.float16),     # fp16, offset
    (2, 4, 1, 130, 130, 64, True, False, torch.float32),    # CUDA cores
])
def test_flash_attention_dq_mma_edges_match_plain(cuda_device, b, hq, hk,
                                                  sq, sk, d, causal, segs,
                                                  dtype):
    """K2 where its tiles meet the edges (q and k lengths off the 64-row
    tile, rows that see no key, head dim 64, fp16, segment ids, GQA and
    MQA) within CARD_TOL of the plain version; bf16 and fp16 take the
    tensor-core body (``mma_launches``), fp32 the CUDA-core body; two runs
    are equal bit for bit (a block owns its dQ rows: no atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, do, seg = _bwd_inputs(gen, cuda_device, b, sq, sk, hq, hk, d,
                                   dtype, segs)
    n, n_mma = (tfa.flash_attention_bwd_dq.launches,
                tfa.flash_attention_bwd_dq.mma_launches)
    got, again, want = _dq(q, k, v, do, causal, seg)
    assert tfa.flash_attention_bwd_dq.launches == n + 2
    assert tfa.flash_attention_bwd_dq.mma_launches == n_mma + 2 * (
        dtype != torch.float32)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert torch.equal(got, again)
    tol = CARD_TOL if dtype != torch.float32 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if causal and sq > sk:  # rows that see no key get dQ = 0 exactly
        assert not got[:, :sq - sk].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h,dtype", [(37, 4096, torch.bfloat16),
                                          (1, 64, torch.bfloat16),
                                          (300, 5120, torch.float32)])
def test_rmsnorm_bwd_matches_plain(cuda_device, rows, h, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = _card((rows, h), gen, cuda_device, dtype)
    w = _card((h,), gen, cuda_device, dtype)
    dy = _card((rows, h), gen, cuda_device, dtype)
    _, rstd = trn.rmsnorm_fwd(x, w, 1e-5)
    before = trn.rmsnorm_bwd.launches
    dx, dw = trn.rmsnorm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert trn.rmsnorm_bwd.launches == before + 1
    dx_ref, dw_ref = trn.rmsnorm_bwd_plain(x, w, rstd, dy)
    tol = CARD_TOL if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx.float(), dx_ref.float(), **tol)
    torch.testing.assert_close(dw.float(), dw_ref.float(), **tol)
    # dx and dweight come from one counted launch, the same bits each run
    again = trn.rmsnorm_bwd(x, w, rstd, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    assert trn.rmsnorm_bwd.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", [(4096, 2048), (4097, 4096), (37, 4544),
                                    (1001, 8192), (531, 16384), (1, 4096)])
def test_rmsnorm_bwd_one_pass_matches_plain_and_repeats(cuda_device, rows,
                                                         h):
    """K5's dx and dweight from one pass over x and dy (and the column sum
    of its partial rows) at hidden 2048, 4096, Falcon's 4544 (masked
    lanes), 8192 and 16384 (the whole row held, spilling registers), with
    rows that the partition does not divide on 132 SMs (4097, 1001 and
    531: the last program's rows run short) and a single row: within
    CARD_TOL of the plain version, equal bit for bit from run to run, one
    counted launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = _card((rows, h), gen, cuda_device)
    w = (1.0 + 0.1 * _card((h,), gen, cuda_device, torch.float32)).to(
        torch.bfloat16)
    dy = _card((rows, h), gen, cuda_device)
    _, rstd = trn.rmsnorm_fwd(x, w, 1e-5)
    before = trn.rmsnorm_bwd.launches
    got = trn.rmsnorm_bwd(x, w, rstd, dy)
    again = trn.rmsnorm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert trn.rmsnorm_bwd.launches == before + 2
    want = trn.rmsnorm_bwd_plain(x, w, rstd, dy)
    for name, g, a, r in zip(("dx", "dw"), got, again, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all(), name
        assert torch.equal(g, a), name
        torch.testing.assert_close(g.float(), r.float(), **CARD_TOL,
                                   msg=name)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_cpu(cuda_device):
    """Two train steps of a small fp32 model (head dim 128, grad_accum 2)
    through the forward and backward kernels on the card, against the same
    steps on the CPU's plain path."""
    from megatron_llm_tpu_torch.config import (
        OptimizerConfig,
        RuntimeConfig,
        TrainConfig,
    )
    from megatron_llm_tpu_torch.training import step as tstep

    cfg = RuntimeConfig(
        model=tiny_config(hidden_size=256, num_attention_heads=2,
                          num_kv_heads=1, ffn_hidden_size=512,
                          attention_impl="flash", norm_impl="pallas",
                          recompute="selective"),
        optimizer=OptimizerConfig(lr=1e-3, lr_warmup_iters=1),
        train=TrainConfig(train_iters=2, micro_batch_size=2,
                          global_batch_size=4, seq_length=24)).validate()
    params = tm.init_params(cfg.model, seed=0, device="cpu")
    toks = torch.randint(0, cfg.model.vocab_size, (2, 2, 2, 25),
                         generator=torch.Generator().manual_seed(0))
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        state = tstep.init_train_state(cfg, _to_dev(params, dev))
        step = tstep.make_train_step(cfg, dev)
        losses = []
        for it in range(2):
            t = toks[it]
            batch = {"tokens": t[..., :-1].to(dev),
                     "labels": t[..., 1:].to(dev),
                     "loss_mask": torch.ones(2, 2, 24, device=dev)}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out[dev.type] = (losses, _to_dev(state.params, "cpu"))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    # Adam divides each grad by its own running RMS, so where a grad is
    # near zero the fp32 reordering of its sums can move that param's
    # update by a few percent of lr (1e-3)
    for a, b in zip(_leaves(out["cuda"][1]), _leaves(out["cpu"][1])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-5)
    launches = {n: fn.launches for n, fn in counters.items()}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "rmsnorm_fwd", "rmsnorm_bwd"):
        assert launches[name] > 0, launches


def _to_dev(tree, dev):
    """A copy of the tree on ``dev`` (the optimizer updates in place)."""
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _int8_cache(gen, dev, shape):
    """int8 codes and positive fp32 row scales, as quantize_rows makes."""
    q = torch.randint(-127, 128, shape, generator=gen, device=dev,
                      dtype=torch.int8)
    scale = 0.01 + 0.05 * torch.rand(shape[:-1], generator=gen, device=dev)
    return q, scale


@pytest.mark.cuda
@pytest.mark.parametrize("nq,kv,d", [(32, 32, 128), (32, 8, 128), (8, 1, 128),
                                     (4, 2, 64), (64, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_int8_matches_plain(cuda_device, nq, kv, d, dtype):
    """K9 against its plain version: fills 0 (the mean of the dequantized
    V), 129, each side of the split boundary and the whole cache."""
    b = len(DECODE_FILLS)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q = _card((b, nq, d), gen, cuda_device, dtype)
    kq, ks = _int8_cache(gen, cuda_device, (b, kv, 512, d))
    vq, vs = _int8_cache(gen, cuda_device, (b, kv, 512, d))
    lens = torch.tensor(DECODE_FILLS, dtype=torch.int32, device=cuda_device)
    before = tfd.flash_decode_int8.launches
    out = tfd.flash_decode_int8(q, kq, ks, vq, vs, lens)
    torch.cuda.synchronize()
    assert tfd.flash_decode_int8.launches == before + 1
    want = tfd.flash_decode_int8_plain(q, kq, ks, vq, vs, lens)
    tol = CARD_TOL if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out.float(), want.float(), **tol)


def _shuffled_tables(gen, dev, lens, n_tbl, block):
    """Tables over a pool whose live blocks are shuffled; entries past a
    row's fill point at the trash block 0."""
    b = len(lens)
    n_blocks = 1 + b * n_tbl
    perm = 1 + torch.randperm(n_blocks - 1, generator=gen, device=dev)
    tables = perm.reshape(b, n_tbl).to(torch.int32)
    for i, n in enumerate(lens):
        live = max(1, -(-n // block))
        tables[i, live:] = 0
    return tables, n_blocks


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 128, 16])
@pytest.mark.parametrize("kv,int8", [(32, False), (8, True), (8, False),
                                     (32, True)])
def test_paged_kernels_equal_dense_bitwise(cuda_device, block, kv, int8):
    """K10 over a shuffled pool equals K8 over the same logical cache bit
    for bit, and K11 equals K9; each also matches its plain version.
    Fills: 1, a block boundary, one past it, the whole width, and 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    nq, d, n_tbl = 32, 128, 512 // block
    width = n_tbl * block
    lens_l = [1, block, block + 1, width, 0]
    b = len(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda_device)
    tables, n_blocks = _shuffled_tables(gen, cuda_device, lens_l, n_tbl,
                                        block)
    q = _card((b, nq, d), gen, cuda_device)
    shape = (n_blocks, kv, block, d)
    if int8:
        kq, ks = _int8_cache(gen, cuda_device, shape)
        vq, vs = _int8_cache(gen, cuda_device, shape)
        pools = (kq, ks, vq, vs)
        paged, dense = tfd.flash_decode_paged_int8, tfd.flash_decode_int8
        plain = tfd.flash_decode_paged_int8_plain
    else:
        pools = (_card(shape, gen, cuda_device),
                 _card(shape, gen, cuda_device))
        paged, dense = tfd.flash_decode_paged, tfd.flash_decode
        plain = tfd.flash_decode_paged_plain
    views = [tfd.gather_blocks(p, tables).contiguous() for p in pools]
    before = paged.launches
    got = paged(q, *pools, tables, lens)
    torch.cuda.synchronize()
    assert paged.launches == before + 1
    want = dense(q, *views, lens)
    assert torch.equal(got, want)
    torch.testing.assert_close(got.float(),
                               plain(q, *pools, tables, lens).float(),
                               **CARD_TOL)


def _decode_calls(kind, gen, dev, nq, kv, fills, block=64, width=1024):
    """(call over rows ``sel``, wrapper) of K8-K11 on one seeded cache."""
    b, d = len(fills), 128
    q = _card((b, nq, d), gen, dev)
    lens = torch.tensor(fills, dtype=torch.int32, device=dev)
    if kind in ("paged", "paged_int8"):
        tables, n_blocks = _shuffled_tables(gen, dev, fills, width // block,
                                            block)
        shape = (n_blocks, kv, block, d)
    else:
        shape = (b, kv, width, d)
    if kind.endswith("int8"):
        kq, ks = _int8_cache(gen, dev, shape)
        vq, vs = _int8_cache(gen, dev, shape)
        leaves = (kq, ks, vq, vs)
    else:
        leaves = (_card(shape, gen, dev), _card(shape, gen, dev))
    fn = {"dense": tfd.flash_decode, "int8": tfd.flash_decode_int8,
          "paged": tfd.flash_decode_paged,
          "paged_int8": tfd.flash_decode_paged_int8}[kind]
    if kind.startswith("paged"):
        return (lambda sel: fn(q[sel], *leaves, tables[sel], lens[sel])), fn
    return (lambda sel: fn(q[sel], *(t[sel] for t in leaves), lens[sel])), fn


@pytest.mark.cuda
@pytest.mark.parametrize("nq,kv", [(32, 32), (64, 8)])
@pytest.mark.parametrize("kind", ["dense", "int8", "paged", "paged_int8"])
def test_decode_split_bits_row_alone_and_repeat(cuda_device, kind, nq, kv):
    """K8-K11 on the split body: each row alone equals its row in a batch
    of other fills, bit for bit; two calls in a row give the same bits (the
    merge's tickets are back to zero after each); the split-body counter
    goes up by exactly the launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    fills = [1000, 1, 257, 0, 511, 1024, 256]
    call, fn = _decode_calls(kind, gen, cuda_device, nq, kv, fills)
    every = slice(None)
    launches, split = fn.launches, fn.split_launches
    first = call(every)
    second = call(every)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for i in range(len(fills)):
        assert torch.equal(call(slice(i, i + 1))[0], first[i]), i
    torch.cuda.synchronize()
    assert fn.launches == launches + 2 + len(fills)
    assert fn.split_launches == split + 2 + len(fills)


@pytest.mark.cuda
def test_split_cols_mirror_the_library(cuda_device):
    """The Python split plan uses the columns the built kernels walk."""
    lib = tfd.build.load("flash_decode")
    assert lib.flash_decode_split_cols() == tfd.SPLIT_COLS


@pytest.mark.cuda
def test_decode_split_first_call_on_a_device(cuda_device):
    """K8 over two splits as the first call on a device: the ticket buffer
    is made in that call, from an emptied allocator, beside the split
    scratch; the result matches the plain version and the next call's bits,
    each time."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    fills = [300, 1, 512, 0, 257]
    q = _card((len(fills), 32, 128), gen, cuda_device)
    kc, vc = (_card((len(fills), 8, 512, 128), gen, cuda_device)
              for _ in range(2))
    lens = torch.tensor(fills, dtype=torch.int32, device=cuda_device)
    want = tfd.flash_decode_plain(q, kc, vc, lens)
    outs = []
    for _ in range(3):
        tfd._TICKETS.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        outs.append(tfd.flash_decode(q, kc, vc, lens))
        outs.append(tfd.flash_decode(q, kc, vc, lens))
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got, outs[0])
    torch.testing.assert_close(outs[0].float(), want.float(), **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 2])
def test_int8_kernels_take_rows_not_in_fours(cuda_device, block):
    """K9 over a max_len that is not a multiple of 4, and K11 over pool
    blocks of 1 and 2 rows, launch (their scales are loaded row by row, not
    bulk-copied): the bits equal K9 over a max_len in fours, where the
    scales are copied with the tiles, and each matches its plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    fills = [301, 1, 257, 302, 256]
    b, nq, kv, d, width = len(fills), 32, 8, 128, 302
    q = _card((b, nq, d), gen, cuda_device)
    lens = torch.tensor(fills, dtype=torch.int32, device=cuda_device)
    kq, ks = _int8_cache(gen, cuda_device, (b, kv, 304, d))
    vq, vs = _int8_cache(gen, cuda_device, (b, kv, 304, d))
    fours = (kq, ks, vq, vs)
    ragged = tuple(t[:, :, :width].contiguous() for t in fours)
    assert tfd.int8_kernel_takes(q, ragged[0])
    before = tfd.flash_decode_int8.launches
    want = tfd.flash_decode_int8(q, *fours, lens)
    got = tfd.flash_decode_int8(q, *ragged, lens)
    torch.cuda.synchronize()
    assert tfd.flash_decode_int8.launches == before + 2
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got.float(), tfd.flash_decode_int8_plain(q, *ragged, lens).float(),
        **CARD_TOL)
    # the same logical cache as a shuffled pool of blocks of 1 or 2 rows
    n_tbl = width // block
    tables, n_blocks = _shuffled_tables(gen, cuda_device, fills, n_tbl,
                                        block)
    pools = []
    for leaf in ragged:
        pool = torch.zeros((n_blocks, kv, block) + tuple(leaf.shape[3:]),
                           dtype=leaf.dtype, device=cuda_device)
        for i, n in enumerate(fills):
            for j in range(-(-n // block)):
                pool[tables[i, j]] = leaf[i, :, j * block:(j + 1) * block]
        pools.append(pool)
    paged = tfd.flash_decode_paged_int8(q, *pools, tables, lens)
    torch.cuda.synchronize()
    assert torch.equal(paged, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_on_card_matches_cpu(cuda_device, dtype):
    """The int8 codes and scales the card writes are the CPU's, bit for
    bit (fp32 division, round half to even), and so are the fake-quantized
    rows and their requantization (same codes; the scale as the CPU's)."""
    gen = torch.Generator().manual_seed(10)
    rows = (3.0 * torch.randn(2, 4, 33, 128, generator=gen)).to(dtype)
    rows[0, 0, 0] = 0.0                              # an all-zero row
    cpu = tkv.quantize_rows(rows)
    card = tkv.quantize_rows(rows.to(cuda_device))
    assert torch.equal(card["q"].cpu(), cpu["q"])
    assert torch.equal(card["scale"].cpu(), cpu["scale"])
    fq_cpu = tkv.fake_quantize_rows(rows.float())
    fq = tkv.fake_quantize_rows(rows.float().to(cuda_device))
    assert torch.equal(fq.cpu(), fq_cpu)
    again, again_cpu = tkv.quantize_rows(fq), tkv.quantize_rows(fq_cpu)
    assert torch.equal(again["q"], card["q"])
    assert torch.equal(again["scale"].cpu(), again_cpu["scale"])


@pytest.mark.cuda
def test_quantized_model_path_on_the_card_matches_cpu(cuda_device):
    """A prefill and paged decode steps of a small fp32 model with an int8
    KV cache and mixed-policy weights (int8 attention, int4 MLP, int8
    embedding) on the card, against the CPU's plain path; decode takes K9,
    and ``paged_decode_attention`` over the filled pool takes K11 and
    equals the gather route bit for bit."""
    cfg = tiny_config(hidden_size=256, num_attention_heads=2, num_kv_heads=1,
                      ffn_hidden_size=512, attention_impl="flash",
                      norm_impl="pallas", fused_decode=False,
                      kv_cache_quant="int8")
    params = tq.quantize_params(tm.init_params(cfg, seed=0, device="cpu"),
                                tq.PrecisionPolicy(attn="int8", mlp="int4",
                                                   embedding="int8",
                                                   group_size=128))
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(0))
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        p = _to_dev(params, dev)
        k, v = tm.init_kv_cache(cfg, 1, 32, device=dev)
        pre, k, v = tm.forward_cached(cfg, p, toks[:, :20].to(dev), k, v, 0,
                                      empty_cache=True)
        k_pool, v_pool = tm.init_kv_pool(cfg, 5, 8, device=dev)
        bids = torch.tensor([3, 1, 4, 2], device=dev)
        tm.cache_scatter_blocks(k_pool, k, bids)
        tm.cache_scatter_blocks(v_pool, v, bids)
        steps = [pre[:, -1]]
        for i in range(4):
            lg, _, _ = tm.forward_cached_paged(
                cfg, p, toks[:, 20 + i:21 + i].to(dev), k_pool, v_pool,
                bids[None], torch.tensor([20 + i], device=dev))
            steps.append(lg[:, 0])
        outs[dev.type] = torch.cat(steps).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)
    assert counters["flash_decode_int8"].launches == 4 * cfg.num_layers
    assert counters["flash_decode"].launches == 0
    layer0 = {kk: vv[0] for kk, vv in k_pool.items()}
    v_layer0 = {kk: vv[0] for kk, vv in v_pool.items()}
    qd = torch.randn(1, 1, 2, 128, device=cuda_device)
    fills = torch.tensor([23], device=cuda_device)
    got = tattn.paged_decode_attention(qd, layer0, v_layer0, bids[None],
                                       fills)
    assert counters["flash_decode_paged_int8"].launches == 1
    dense = {kk: tfd.gather_blocks(vv, bids[None]).contiguous()
             for kk, vv in layer0.items()}
    v_dense = {kk: tfd.gather_blocks(vv, bids[None]).contiguous()
               for kk, vv in v_layer0.items()}
    assert torch.equal(got, tattn.decode_attention(qd, dense, v_dense, fills))


# ---------------------------------------------------------------------------
# The fused whole-stack decode step: K12 (dense), K13 (paged), K14 (verify)
# ---------------------------------------------------------------------------


def _fused_setup(dev, kv=8, policy=None, int8_cache=False, dtype="bfloat16",
                 hidden=1024, heads=8, ffn=1536, layers=2):
    """A Llama-style stack at head dim 128 (2 layers), its params on the
    card, quantized under ``policy``; ``(cfg, stacked params, rope)``."""
    from megatron_llm_tpu_torch.config import llama2_config

    cfg = llama2_config("7b", hidden_size=hidden, num_layers=layers,
                        num_attention_heads=heads, num_kv_heads=kv,
                        ffn_hidden_size=ffn, vocab_size=256,
                        params_dtype=dtype,
                        kv_cache_quant="int8" if int8_cache else "none")
    params = tm.init_params(cfg, seed=0, device="cpu")
    if policy is not None:
        params = tq.quantize_params(params, tq.PrecisionPolicy(
            attn=policy[0], mlp=policy[1], group_size=128))
    params = _to_dev(params, dev)
    return cfg, params["layers"], tm.rope_tables(cfg, device=dev)


def _fused_cache(gen, dev, cfg, shape, int8_cache):
    if int8_cache:
        q, s = _int8_cache(gen, dev, shape)
        return {"q": q, "scale": s}
    return _card(shape, gen, dev, cfg.dtype)


def _pool_from_dense(dense, tables, block):
    """Dense leaves ``[L, b, kv, width(, d)]`` laid out as a pool at the
    tables' ids (the rest of the pool holds large finite values)."""
    if isinstance(dense, dict):
        return {k: _pool_from_dense(v, tables, block)
                for k, v in dense.items()}
    L, b, kv, width = dense.shape[:4]
    n_tbl = width // block
    pool = torch.full((L, 1 + b * n_tbl, kv, block) + tuple(dense.shape[4:]),
                      100, dtype=dense.dtype, device=dense.device)
    for bi in range(b):
        for j in range(n_tbl):
            pool[:, int(tables[bi, j])] = dense[:, bi, :, j * block:
                                                (j + 1) * block]
    return pool


def _assert_fused_close(got, want, int8_cache=False):
    """Hidden and K/V rows of a fused step against the plain version's.
    bf16 and fp32 caches: within CARD_TOL.  An int8 cache's fp32 rows are
    fake-quantized, and a raw value a few ulps from the plain version's can
    round to the neighbouring code: the first layer's rows may differ by
    one code step (the row's max / 127); such a flip then moves the next
    layer's inputs, so the hidden state and all rows are held to a
    relative (Frobenius) error of 1e-2 (a wrong kernel errs by order 1)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        g, w = g.float(), w.float()
        if not int8_cache:
            torch.testing.assert_close(g, w, **CARD_TOL)
            continue
        rel = torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)
        assert float(rel) <= 1e-2, (i, float(rel))
        if i:
            step = w[0].abs().amax(-1, keepdim=True) / 127
            assert ((g[0] - w[0]).abs() <= 1.01 * step + 1e-6).all()


FUSED_CASES = {
    "bf16": dict(),
    "gqa-int8-cache-int8-weights": dict(kv=2, policy=("int8", "int8"),
                                        int8_cache=True),
    "mqa-int4-weights": dict(kv=1, policy=("int4", "int4")),
    "mixed-weights-int8-cache": dict(policy=("int8", "int4"),
                                     int8_cache=True),
    "fp32": dict(dtype="float32"),
    # widths that leave the bf16 body's TMA boxes ragged: q 320 columns
    # (2.5 boxes of 128 int8 columns), k/v 64 (under one box), gate/up 480
    # (7.5 boxes of 64 bf16 columns), w_down in three 160-row segments
    "ragged-boxes": dict(kv=1, hidden=320, heads=5, ffn=480),
    "ragged-boxes-int8": dict(kv=1, hidden=320, heads=5, ffn=480,
                              policy=("int8", "int8"), int8_cache=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FUSED_CASES))
def test_fused_decode_kernels_match_plain(cuda_device, name):
    """K12, K13 and K14 (W = 4) against their plain versions on the same
    card tensors: fills 0, 1, 97 and the whole width of 256.  bf16 runs
    the TMA body (the launcher's report, ``tma_launches``), fp32 the
    CUDA-core body; a second K13 call gives the same bits."""
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    c = FUSED_CASES[name]
    cfg, stacked, rope = _fused_setup(cuda_device, **c)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    fills = torch.tensor([0, 1, 97, 256 - 4], device=cuda_device)
    b, width, block = 4, 256, 64
    shape = (cfg.num_layers, b, cfg.kv_heads, width, cfg.head_dim)
    k = _fused_cache(gen, cuda_device, cfg, shape, c.get("int8_cache"))
    v = _fused_cache(gen, cuda_device, cfg, shape, c.get("int8_cache"))
    x = _card((b, cfg.hidden_size), gen, cuda_device, cfg.dtype)
    counters = {n: getattr(tds, n) for n in (
        "fused_decode_step", "fused_decode_step_paged",
        "fused_decode_verify_paged")}
    before = {n: f.launches for n, f in counters.items()}
    tma = {n: f.tma_launches for n, f in counters.items()}
    got = tds.fused_decode_step(cfg, stacked, x, k, v, fills, rope)
    q8 = c.get("int8_cache", False)
    _assert_fused_close(got, tds.fused_decode_step_plain(
        cfg, stacked, x, k, v, fills, rope), q8)
    tables = (1 + torch.randperm(b * width // block, generator=gen,
                                 device=cuda_device)).reshape(b, -1)
    kp = _pool_from_dense(k, tables, block)
    vp = _pool_from_dense(v, tables, block)
    got = tds.fused_decode_step_paged(cfg, stacked, x, kp, vp, tables, fills,
                                      rope)
    _assert_fused_close(got, tds.fused_decode_step_paged_plain(
        cfg, stacked, x, kp, vp, tables, fills, rope), q8)
    again = tds.fused_decode_step_paged(cfg, stacked, x, kp, vp, tables,
                                        fills, rope)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    xw = _card((b, 4, cfg.hidden_size), gen, cuda_device, cfg.dtype)
    got = tds.fused_decode_verify_paged(cfg, stacked, xw, kp, vp, tables,
                                        fills, rope)
    _assert_fused_close(got, tds.fused_decode_verify_paged_plain(
        cfg, stacked, xw, kp, vp, tables, fills, rope), q8)
    torch.cuda.synchronize()
    ran = {n: f.launches - before[n] for n, f in counters.items()}
    assert ran == {"fused_decode_step": 1, "fused_decode_step_paged": 2,
                   "fused_decode_verify_paged": 1}
    on_tma = {n: f.tma_launches - tma[n] for n, f in counters.items()}
    assert on_tma == (ran if cfg.dtype == torch.bfloat16
                      else dict.fromkeys(counters, 0))


def _append_rows(pool, rows, tables, pos, block):
    """The host's write of a fused step's rows into the pool."""
    bids = tables[torch.arange(tables.shape[0], device=tables.device),
                  pos // block]
    if isinstance(pool, dict):
        rows = tkv.quantize_rows(rows)
    tm.cache_append_rows(pool, rows, bids, pos % block)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 64, 128])
@pytest.mark.parametrize("kv,int8_cache,policy", [
    (32, False, None), (8, True, None), (8, False, ("int8", "int8")),
    (32, True, ("int4", "int4"))])
def test_fused_paged_equals_dense_and_verify_equals_steps(
        cuda_device, block, kv, int8_cache, policy):
    """K13 over a shuffled pool equals K12 over the same logical cache bit
    for bit, and K14 over a W = 4 window equals four K13 steps with the
    host's pool writes between them bit for bit (hidden and rows), at
    Llama-2-7B's heads (32 x 128).  Fills: 0, 1, a block boundary, one past
    it, and the width less the window."""
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    cfg, stacked, rope = _fused_setup(cuda_device, kv=kv, policy=policy,
                                      int8_cache=int8_cache, hidden=4096,
                                      heads=32, ffn=1024)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    width, W = 512, 4
    fills = torch.tensor([0, 1, block, block + 1, width - W],
                         device=cuda_device)
    b = len(fills)
    shape = (cfg.num_layers, b, kv, width, cfg.head_dim)
    k = _fused_cache(gen, cuda_device, cfg, shape, int8_cache)
    v = _fused_cache(gen, cuda_device, cfg, shape, int8_cache)
    tables = (1 + torch.randperm(b * width // block, generator=gen,
                                 device=cuda_device)).reshape(b, -1)
    kp = _pool_from_dense(k, tables, block)
    vp = _pool_from_dense(v, tables, block)
    x = _card((b, W, cfg.hidden_size), gen, cuda_device, cfg.dtype)
    dense = tds.fused_decode_step(cfg, stacked, x[:, 0].contiguous(), k, v,
                                  fills, rope)
    paged = tds.fused_decode_step_paged(cfg, stacked, x[:, 0].contiguous(),
                                        kp, vp, tables, fills, rope)
    for a, d in zip(paged, dense):
        assert torch.equal(a, d)
    verify = tds.fused_decode_verify_paged(cfg, stacked, x, kp, vp, tables,
                                           fills, rope)

    def copy(p):
        return {n: t.clone() for n, t in p.items()} if isinstance(p, dict) \
            else p.clone()

    kp2, vp2 = copy(kp), copy(vp)
    steps = []
    for j in range(W):
        out = tds.fused_decode_step_paged(cfg, stacked, x[:, j].contiguous(),
                                          kp2, vp2, tables, fills + j, rope)
        _append_rows(kp2, out[1], tables, fills + j, block)
        _append_rows(vp2, out[2], tables, fills + j, block)
        steps.append(out)
    assert torch.equal(verify[0], torch.stack([s[0] for s in steps], 1))
    for i in (1, 2):
        seq = torch.stack([s[i] for s in steps], 2).reshape(verify[i].shape)
        assert torch.equal(verify[i], seq)


# K14's tree mode: a chain, and a branched tree with a depth-1 hedge (the
# engine's shape); pad slots sit at depth 0 as the engine's riders do
TREES = {
    "chain": ([0, 1, 2, 3], {(1, 0): 0, (2, 0): 0, (2, 1): 1, (3, 0): 0,
                             (3, 1): 1, (3, 2): 2}),
    "hedge": ([0, 1, 1, 2], {(3, 1): 1}),
    "rider": ([0, 0, 0, 0], {}),
}


def _tree(specs, dev):
    """``(depths [S, 4], anc [S, 4, 4])`` on ``dev`` from one ``(depths,
    {(node, depth): ancestor})`` spec per slot."""
    W = 4
    depths = torch.zeros(len(specs), W, dtype=torch.int32)
    anc = torch.zeros(len(specs), W, W, dtype=torch.int32)
    for s, (dep, links) in enumerate(specs):
        depths[s] = torch.tensor(dep)
        for (j, dd), a in links.items():
            anc[s, j, dd] = a
    return depths.to(dev), anc.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FUSED_CASES))
def test_fused_tree_verify_matches_plain(cuda_device, name):
    """K14's tree mode against its plain version on the same card
    tensors (chain, hedge and rider slots; fills 0, 1, 97, 252)."""
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    c = FUSED_CASES[name]
    cfg, stacked, rope = _fused_setup(cuda_device, **c)
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    fills = torch.tensor([0, 1, 97, 256 - 4], device=cuda_device)
    b, width, block = 4, 256, 64
    shape = (cfg.num_layers, b, cfg.kv_heads, width, cfg.head_dim)
    q8 = c.get("int8_cache", False)
    k = _fused_cache(gen, cuda_device, cfg, shape, q8)
    v = _fused_cache(gen, cuda_device, cfg, shape, q8)
    tables = (1 + torch.randperm(b * width // block, generator=gen,
                                 device=cuda_device)).reshape(b, -1)
    kp = _pool_from_dense(k, tables, block)
    vp = _pool_from_dense(v, tables, block)
    xw = _card((b, 4, cfg.hidden_size), gen, cuda_device, cfg.dtype)
    depths, anc = _tree([TREES[n] for n in ("hedge", "chain", "rider",
                                            "hedge")], cuda_device)
    before = tds.fused_decode_verify_tree_paged.launches
    got = tds.fused_decode_verify_paged(cfg, stacked, xw, kp, vp, tables,
                                        fills, rope, depths=depths, anc=anc)
    torch.cuda.synchronize()
    assert tds.fused_decode_verify_tree_paged.launches == before + 1
    _assert_fused_close(got, tds.fused_decode_verify_tree_paged_plain(
        cfg, stacked, xw, kp, vp, tables, fills, rope, depths, anc), q8)


@pytest.mark.cuda
@pytest.mark.parametrize("kv,int8_cache,policy", [
    (32, False, None), (8, True, None), (8, False, ("int8", "int8")),
    (32, True, ("int4", "int4"))])
def test_fused_tree_chain_equals_linear_and_branches_equal_steps(
        cuda_device, kv, int8_cache, policy):
    """At Llama-2-7B's heads: a chain tree through K14's tree mode equals
    the linear K14 window bit for bit, and every node of a hedged tree
    equals sequential K13 steps down its root path (with the host's pool
    writes between them) bit for bit.  Fills 0, 1, a block boundary less
    one (the depth-2 nodes cross it) and the width less the window."""
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    cfg, stacked, rope = _fused_setup(cuda_device, kv=kv, policy=policy,
                                      int8_cache=int8_cache, hidden=4096,
                                      heads=32, ffn=1024)
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    width, W, block = 512, 4, 64
    fills = torch.tensor([0, 1, block - 1, width - W], device=cuda_device)
    b = len(fills)
    shape = (cfg.num_layers, b, kv, width, cfg.head_dim)
    k = _fused_cache(gen, cuda_device, cfg, shape, int8_cache)
    v = _fused_cache(gen, cuda_device, cfg, shape, int8_cache)
    tables = (1 + torch.randperm(b * width // block, generator=gen,
                                 device=cuda_device)).reshape(b, -1)
    kp = _pool_from_dense(k, tables, block)
    vp = _pool_from_dense(v, tables, block)
    x = _card((b, W, cfg.hidden_size), gen, cuda_device, cfg.dtype)
    linear = tds.fused_decode_verify_paged(cfg, stacked, x, kp, vp, tables,
                                           fills, rope)
    depths, anc = _tree([TREES["chain"]] * b, cuda_device)
    chain = tds.fused_decode_verify_paged(cfg, stacked, x, kp, vp, tables,
                                          fills, rope, depths=depths, anc=anc)
    for a, c in zip(chain, linear):
        assert torch.equal(a, c)
    depths, anc = _tree([TREES["hedge"]] * b, cuda_device)
    tree = tds.fused_decode_verify_paged(cfg, stacked, x, kp, vp, tables,
                                         fills, rope, depths=depths, anc=anc)

    def copy(p):
        return {n: t.clone() for n, t in p.items()} if isinstance(p, dict) \
            else p.clone()

    rows = torch.arange(b, device=cuda_device) * W
    for path in ([0, 1, 3], [0, 2]):
        kp2, vp2 = copy(kp), copy(vp)
        for t, node in enumerate(path):
            out = tds.fused_decode_step_paged(
                cfg, stacked, x[:, node].contiguous(), kp2, vp2, tables,
                fills + t, rope)
            assert torch.equal(tree[0][:, node], out[0])
            assert torch.equal(tree[1][:, rows + node], out[1])
            assert torch.equal(tree[2][:, rows + node], out[2])
            _append_rows(kp2, out[1], tables, fills + t, block)
            _append_rows(vp2, out[2], tables, fills + t, block)


@pytest.mark.cuda
def test_fused_tree_kernel_refuses_a_bad_tree(cuda_device):
    """The launch checks the tree itself: a depth past the node index, a
    later ancestor, or a root off depth 0 fails the launch (the wrapper
    raises), with no fallback."""
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    cfg, stacked, rope = _fused_setup(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    pool = _card((cfg.num_layers, 5, cfg.kv_heads, 16, cfg.head_dim), gen,
                 cuda_device)
    tables = torch.tensor([[1, 2], [3, 4]], device=cuda_device)
    x = _card((2, 4, cfg.hidden_size), gen, cuda_device)
    fills = torch.tensor([3, 5], device=cuda_device)
    for bad in (([0, 2, 2, 2], {}), ([0, 1, 1, 2], {(3, 1): 3}),
                ([1, 1, 1, 1], {})):
        depths, anc = _tree([bad, TREES["hedge"]], cuda_device)
        with pytest.raises(RuntimeError, match="launch failed"):
            tds.fused_decode_verify_tree_paged(cfg, stacked, x, pool, pool,
                                               tables, fills, rope, depths,
                                               anc)


@pytest.mark.cuda
def test_fused_model_paths_on_the_card_match_cpu(cuda_device):
    """``forward_cached`` at s = 1 (K12) and ``forward_cached_paged`` and
    ``forward_cached_paged_verify`` on the fused route (K13, K14) of a
    small fp32 model on the card, against the same calls on the CPU (the
    kernels' plain versions)."""
    from megatron_llm_tpu_torch.config import llama2_config

    cfg = llama2_config("7b", hidden_size=256, num_layers=2,
                        num_attention_heads=2, ffn_hidden_size=512,
                        vocab_size=256, params_dtype="float32",
                        attention_impl="flash", norm_impl="pallas")
    params = tm.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        p = _to_dev(params, dev)
        t = toks.to(dev)
        k, v = tm.init_kv_cache(cfg, 2, 32, device=dev)
        pre, k, v = tm.forward_cached(cfg, p, t[:, :16], k, v, 0,
                                      empty_cache=True, last_logit_only=True)
        lg, k, v = tm.forward_cached(cfg, p, t[:, 16:17], k, v, 16)
        k_pool, v_pool = tm.init_kv_pool(cfg, 5, 16, device=dev)
        bids = torch.tensor([[3, 1], [4, 2]], device=dev)
        for s in range(2):
            tm.cache_scatter_blocks(k_pool, k[:, s:s + 1], bids[s])
            tm.cache_scatter_blocks(v_pool, v[:, s:s + 1], bids[s])
        fills = torch.tensor([17, 17], device=dev)
        st, _, _ = tm.forward_cached_paged(cfg, p, t[:, 17:18], k_pool,
                                           v_pool, bids, fills,
                                           use_fused=True)
        pos = (fills + 1)[:, None] + torch.arange(3, device=dev)[None, :]
        vb = torch.gather(bids, 1, pos // 16).reshape(-1)
        vf, _, _ = tm.forward_cached_paged_verify(
            cfg, p, t[:, 18:21], k_pool, v_pool, bids, fills + 1, vb,
            (pos % 16).reshape(-1), use_fused=True)
        outs[dev.type] = [o.cpu() for o in (pre, lg, st, vf)]
    for c, g in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-4)
    launches = {n: fn.launches for n, fn in counters.items()}
    assert launches["fused_decode_step"] == 1
    assert launches["fused_decode_step_paged"] == 1
    assert launches["fused_decode_verify_paged"] == 1
    assert launches["flash_decode"] == 0
    # fp32: the CUDA-core body, as the C launcher reports it
    assert all(launches[n] == 0 for n in launches if n.endswith("_tma"))


@pytest.mark.cuda
def test_fused_wrappers_refuse_what_the_kernel_does_not_take(cuda_device):
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    cfg, stacked, rope = _fused_setup(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = _card((2, cfg.hidden_size), gen, cuda_device)
    shape = (cfg.num_layers, 2, cfg.kv_heads, 64, cfg.head_dim)
    k, v = _card(shape, gen, cuda_device), _card(shape, gen, cuda_device)
    fills = torch.tensor([3, 5], device=cuda_device)
    with pytest.raises(ValueError):                 # x in another dtype
        tds.fused_decode_step(cfg, stacked, x.float(), k, v, fills, rope)
    with pytest.raises(ValueError):                 # a cache in fp32
        tds.fused_decode_step(cfg, stacked, x, k.float(), v.float(), fills,
                              rope)
    tables = torch.ones(2, 8, dtype=torch.int32, device=cuda_device)
    pool = _card((cfg.num_layers, 4, cfg.kv_heads, 8, cfg.head_dim), gen,
                 cuda_device)
    with pytest.raises(ValueError):                 # pool block 8
        tds.fused_decode_step_paged(cfg, stacked, x, pool, pool, tables,
                                    fills, rope)
    pool = _card((cfg.num_layers, 4, cfg.kv_heads, 16, cfg.head_dim), gen,
                 cuda_device)
    with pytest.raises(ValueError):                 # a window of 9
        tds.fused_decode_verify_paged(
            cfg, stacked, _card((2, 9, cfg.hidden_size), gen, cuda_device),
            pool, pool, tables, fills, rope)
    odd, ostacked, orope = _fused_setup(cuda_device, hidden=768, heads=8)
    with pytest.raises(ValueError):                 # head dim 96
        tds.fused_decode_step(odd, ostacked,
                              _card((2, 768), gen, cuda_device),
                              _card((2, 2, 8, 64, 96), gen, cuda_device),
                              _card((2, 2, 8, 64, 96), gen, cuda_device),
                              fills, orope)


# ---------------------------------------------------------------------------
# The LoRA epilogue of K12-K14 (multi-tenant adapters)
# ---------------------------------------------------------------------------

# rows at slots -1 (the base model), 0, 2 and 3 of a 4-slot x rank-32 arena
LORA_SLOTS = [-1, 0, 2, 3]


def _lora(cfg, dev, gen, slots, n_slots=4, rank=32, targets=None):
    """``(arenas, mask)``: every slot holds an adapter with A ~ N(0, 1/in)
    and B ~ N(0, 0.05^2) over ``targets`` (all seven by default)."""
    from megatron_llm_tpu_torch.ops import lora as tl

    targets = tl.LORA_TARGETS if targets is None else targets
    arenas = tl.make_arenas(cfg, n_slots, rank, targets, device=dev)
    for s in range(n_slots):
        ad = tl.init_lora_adapter(cfg, gen, rank, targets, device=dev)
        for f in ad.factors.values():
            f["b"].normal_(generator=gen).mul_(0.05)
        tl.install_adapter(arenas, ad.factors, s, ad.scale, rank)
    return arenas, tl.slot_mask(torch.tensor(slots, device=dev), n_slots,
                                rank)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FUSED_CASES))
def test_fused_lora_kernels_match_plain(cuda_device, name):
    """K12, K13, K14 (W = 4) and K14's tree mode with a LoRA arena
    (every target) against their plain versions on the same card
    tensors; rows at slots -1, 0, 2, 3.  Each launch counts on its
    wrapper's ``lora`` counter."""
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    c = FUSED_CASES[name]
    cfg, stacked, rope = _fused_setup(cuda_device, **c)
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    fills = torch.tensor([0, 1, 97, 256 - 4], device=cuda_device)
    b, width, block = 4, 256, 64
    shape = (cfg.num_layers, b, cfg.kv_heads, width, cfg.head_dim)
    q8 = c.get("int8_cache", False)
    k = _fused_cache(gen, cuda_device, cfg, shape, q8)
    v = _fused_cache(gen, cuda_device, cfg, shape, q8)
    x = _card((b, cfg.hidden_size), gen, cuda_device, cfg.dtype)
    lora = _lora(cfg, cuda_device, gen, LORA_SLOTS)
    fns = (tds.fused_decode_step, tds.fused_decode_step_paged,
           tds.fused_decode_verify_paged, tds.fused_decode_verify_tree_paged)
    before = [f.lora.launches for f in fns]
    got = tds.fused_decode_step(cfg, stacked, x, k, v, fills, rope,
                                lora=lora)
    _assert_fused_close(got, tds.fused_decode_step_plain(
        cfg, stacked, x, k, v, fills, rope, lora), q8)
    tables = (1 + torch.randperm(b * width // block, generator=gen,
                                 device=cuda_device)).reshape(b, -1)
    kp = _pool_from_dense(k, tables, block)
    vp = _pool_from_dense(v, tables, block)
    got = tds.fused_decode_step_paged(cfg, stacked, x, kp, vp, tables, fills,
                                      rope, lora=lora)
    _assert_fused_close(got, tds.fused_decode_step_paged_plain(
        cfg, stacked, x, kp, vp, tables, fills, rope, lora), q8)
    xw = _card((b, 4, cfg.hidden_size), gen, cuda_device, cfg.dtype)
    got = tds.fused_decode_verify_paged(cfg, stacked, xw, kp, vp, tables,
                                        fills, rope, lora=lora)
    _assert_fused_close(got, tds.fused_decode_verify_paged_plain(
        cfg, stacked, xw, kp, vp, tables, fills, rope, lora), q8)
    depths, anc = _tree([TREES[n] for n in ("hedge", "chain", "rider",
                                            "hedge")], cuda_device)
    got = tds.fused_decode_verify_paged(cfg, stacked, xw, kp, vp, tables,
                                        fills, rope, depths=depths, anc=anc,
                                        lora=lora)
    _assert_fused_close(got, tds.fused_decode_verify_tree_paged_plain(
        cfg, stacked, xw, kp, vp, tables, fills, rope, depths, anc, lora),
        q8)
    torch.cuda.synchronize()
    assert [f.lora.launches - n for f, n in zip(fns, before)] == [1] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("kv,int8_cache,policy", [
    (32, False, None), (8, True, ("int8", "int8")),
    (32, False, ("int4", "int4"))])
def test_fused_lora_contracts_bitwise(cuda_device, kv, int8_cache, policy):
    """At Llama-2-7B's heads (32 x 128), 2 layers, with an arena on every
    target, bit for bit: rows at slot -1 equal the call without an arena;
    each row of a mixed batch equals that row alone; K13 equals K12; K14
    equals four K13 steps; a chain tree equals the linear window and each
    path of a hedged tree sequential K13 steps."""
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    cfg, stacked, rope = _fused_setup(cuda_device, kv=kv, policy=policy,
                                      int8_cache=int8_cache, hidden=4096,
                                      heads=32, ffn=1024)
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    width, W, block = 512, 4, 64
    fills = torch.tensor([0, 1, block - 1, width - W], device=cuda_device)
    b = len(fills)
    shape = (cfg.num_layers, b, kv, width, cfg.head_dim)
    k = _fused_cache(gen, cuda_device, cfg, shape, int8_cache)
    v = _fused_cache(gen, cuda_device, cfg, shape, int8_cache)
    tables = (1 + torch.randperm(b * width // block, generator=gen,
                                 device=cuda_device)).reshape(b, -1)
    kp = _pool_from_dense(k, tables, block)
    vp = _pool_from_dense(v, tables, block)
    x = _card((b, W, cfg.hidden_size), gen, cuda_device, cfg.dtype)
    x0 = x[:, 0].contiguous()
    lora = _lora(cfg, cuda_device, gen, LORA_SLOTS)

    def eq(a, b_):
        for p, q in zip(a, b_):
            assert torch.equal(p, q)

    paged = tds.fused_decode_step_paged(cfg, stacked, x0, kp, vp, tables,
                                        fills, rope, lora=lora)
    eq(paged, tds.fused_decode_step(cfg, stacked, x0, k, v, fills, rope,
                                    lora=lora))
    base = tds.fused_decode_step_paged(cfg, stacked, x0, kp, vp, tables,
                                       fills, rope)
    assert torch.equal(paged[0][0], base[0][0])
    assert torch.equal(paged[1][:, 0], base[1][:, 0])
    assert not torch.equal(paged[0][1], base[0][1])   # the adapters act
    for i in range(b):
        alone = tds.fused_decode_step_paged(
            cfg, stacked, x0[i:i + 1], kp, vp, tables[i:i + 1],
            fills[i:i + 1], rope, lora=(lora[0], lora[1][i:i + 1]))
        assert torch.equal(alone[0][0], paged[0][i])
        assert torch.equal(alone[1][:, 0], paged[1][:, i])
    verify = tds.fused_decode_verify_paged(cfg, stacked, x, kp, vp, tables,
                                           fills, rope, lora=lora)

    def copy(p):
        return {n: t.clone() for n, t in p.items()} if isinstance(p, dict) \
            else p.clone()

    kp2, vp2 = copy(kp), copy(vp)
    steps = []
    for j in range(W):
        out = tds.fused_decode_step_paged(cfg, stacked, x[:, j].contiguous(),
                                          kp2, vp2, tables, fills + j, rope,
                                          lora=lora)
        _append_rows(kp2, out[1], tables, fills + j, block)
        _append_rows(vp2, out[2], tables, fills + j, block)
        steps.append(out)
    assert torch.equal(verify[0], torch.stack([s[0] for s in steps], 1))
    for i in (1, 2):
        seq = torch.stack([s[i] for s in steps], 2).reshape(verify[i].shape)
        assert torch.equal(verify[i], seq)
    depths, anc = _tree([TREES["chain"]] * b, cuda_device)
    eq(tds.fused_decode_verify_paged(cfg, stacked, x, kp, vp, tables, fills,
                                     rope, depths=depths, anc=anc,
                                     lora=lora), verify)
    depths, anc = _tree([TREES["hedge"]] * b, cuda_device)
    tree = tds.fused_decode_verify_paged(cfg, stacked, x, kp, vp, tables,
                                         fills, rope, depths=depths, anc=anc,
                                         lora=lora)
    rows = torch.arange(b, device=cuda_device) * W
    for path in ([0, 1, 3], [0, 2]):
        kp2, vp2 = copy(kp), copy(vp)
        for t, node in enumerate(path):
            out = tds.fused_decode_step_paged(
                cfg, stacked, x[:, node].contiguous(), kp2, vp2, tables,
                fills + t, rope, lora=lora)
            assert torch.equal(tree[0][:, node], out[0])
            assert torch.equal(tree[1][:, rows + node], out[1])
            _append_rows(kp2, out[1], tables, fills + t, block)
            _append_rows(vp2, out[2], tables, fills + t, block)


@pytest.mark.cuda
def test_fused_lora_wrappers_refuse_what_the_kernel_does_not_take(
        cuda_device):
    """An arena off 32-column tiles, or a mask of the wrong shape, raises
    on the card (no fallback)."""
    from megatron_llm_tpu_torch.kernels import decode_step as tds

    cfg, stacked, rope = _fused_setup(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    x = _card((2, cfg.hidden_size), gen, cuda_device)
    shape = (cfg.num_layers, 2, cfg.kv_heads, 64, cfg.head_dim)
    k, v = _card(shape, gen, cuda_device), _card(shape, gen, cuda_device)
    fills = torch.tensor([3, 5], device=cuda_device)
    arenas, mask = _lora(cfg, cuda_device, gen, [0, 1], n_slots=3, rank=8)
    with pytest.raises(ValueError, match="LoRA"):   # Sr 24
        tds.fused_decode_step(cfg, stacked, x, k, v, fills, rope,
                              lora=(arenas, mask))
    arenas, mask = _lora(cfg, cuda_device, gen, [0, 1])
    with pytest.raises(ValueError, match="LoRA"):   # 3 mask rows for 2
        tds.fused_decode_step(cfg, stacked, x, k, v, fills, rope,
                              lora=(arenas, torch.cat([mask, mask[:1]])))


def _generation_model(fused: bool):
    """A small fp32 Llama-style model (head dim 128) whose single-token
    steps take K12 at ``fused_decode=True`` and K8 at ``False``, with its
    prefill on K1 and its norms on K4."""
    from megatron_llm_tpu_torch.config import llama2_config

    cfg = llama2_config("7b", hidden_size=256, num_layers=2,
                        num_attention_heads=2, ffn_hidden_size=512,
                        vocab_size=256, seq_length=128,
                        max_position_embeddings=128, params_dtype="float32",
                        attention_impl="flash", norm_impl="pallas",
                        fused_decode=fused)
    return cfg, tm.init_params(cfg, seed=3, device="cpu")


def _zero_counts():
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


@pytest.mark.cuda
def test_beam_search_on_the_card_matches_cpu(cuda_device):
    """A width-4 beam through K1, K4 and K12 on the card equals the same
    search on the CPU (the kernels' plain versions): the hypotheses token
    for token, the scores within 1e-4 (fp32 sums in another order)."""
    from megatron_llm_tpu_torch.generation import beam_search

    cfg, params = _generation_model(True)
    toks = torch.zeros(40, dtype=torch.long)
    toks[:24] = torch.randint(1, 256, (24,),
                              generator=torch.Generator().manual_seed(5))
    cpu = beam_search(cfg, params, toks, 24, beam_size=4, stop_token=-1,
                      num_return_gen=4)
    counters = _zero_counts()
    card = beam_search(cfg, _to_dev(params, cuda_device), toks, 24,
                       beam_size=4, stop_token=-1, num_return_gen=4)
    print("beam tokens (card):", card.tokens[:, 24:].tolist())
    assert torch.equal(card.tokens.cpu(), cpu.tokens)
    assert torch.equal(card.lengths.cpu(), cpu.lengths)
    torch.testing.assert_close(card.scores.cpu(), cpu.scores, rtol=1e-4,
                               atol=1e-4)
    launches = {n: fn.launches for n, fn in counters.items()}
    assert launches["fused_decode_step"] == 40 - 24 - 1
    assert launches["flash_attention_fwd"] == cfg.num_layers
    assert launches["rmsnorm_fwd"] > 0 and launches["flash_decode"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_generate_tokens_on_the_card_matches_cpu(cuda_device, fused):
    """Ragged greedy generation on the card equals the CPU's: at
    ``fused_decode=True`` each decode step is one K12 launch, at ``False``
    each layer's decode attention a K8 launch."""
    from megatron_llm_tpu_torch.generation import generate_tokens

    cfg, params = _generation_model(fused)
    gen = torch.Generator().manual_seed(6)
    toks = torch.zeros((3, 48), dtype=torch.long)
    lens = torch.tensor([20, 27, 33])
    for i, n in enumerate(lens.tolist()):
        toks[i, :n] = torch.randint(1, 256, (n,), generator=gen)
    cpu = generate_tokens(cfg, params, toks, lens, use_eos_stop=False)
    counters = _zero_counts()
    card = generate_tokens(cfg, _to_dev(params, cuda_device), toks, lens,
                           use_eos_stop=False)
    print(f"fused_decode={fused} tokens (card):",
          [card.tokens[i, n:].tolist() for i, n in enumerate(lens.tolist())])
    assert torch.equal(card.tokens.cpu(), cpu.tokens)
    launches = {n: fn.launches for n, fn in counters.items()}
    steps = 48 - 20 - 1
    if fused:
        assert launches["fused_decode_step"] == steps
        assert launches["flash_decode"] == 0
    else:
        assert launches["fused_decode_step"] == 0
        assert launches["flash_decode"] == steps * cfg.num_layers


@pytest.mark.cuda
def test_safetensors_read_and_write_on_the_card_in_pieces(cuda_device,
                                                          tmp_path,
                                                          monkeypatch):
    """Leaves larger than a piece cross between the file and the card in
    pieces, through one pinned buffer, bit for bit; a cast read and a
    read into a non-contiguous tensor go through a temporary."""
    from megatron_llm_tpu_torch import safetensors_io as sio

    monkeypatch.setattr(sio, "_PIECE", 1000)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    t = {"a": _card((37, 129), gen, cuda_device),
         "b": torch.randn(3001, generator=gen, device=cuda_device),
         "c": torch.arange(5, dtype=torch.int8, device=cuda_device)}
    sio.save_file(t, tmp_path / "x.safetensors")
    f = sio.SafeFile(tmp_path / "x.safetensors")
    for k, v in t.items():
        assert torch.equal(f.get(k, cuda_device), v), k
        assert torch.equal(f.get(k, "cpu"), v.cpu()), k
    assert torch.equal(f.get("a", cuda_device, torch.float32),
                       t["a"].float())
    out = torch.empty(129, 37, dtype=torch.bfloat16, device=cuda_device).T
    assert torch.equal(f.read_into("a", out), t["a"])
