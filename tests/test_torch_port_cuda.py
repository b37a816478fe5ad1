"""The port's CUDA kernels vs their plain twins, on an NVIDIA GPU.

Marked ``cuda``; every test skips where torch sees no CUDA device. Imports
torch and numpy only, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import pytest
import torch

from avsr_tpu_torch.ops.kernels import beam_update as pbu
from avsr_tpu_torch.ops.kernels import decode_attention as pda
from avsr_tpu_torch.ops.kernels import flash_attention as pfa
from avsr_tpu_torch.ops.kernels import row_gather as prg
from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl
from avsr_tpu_torch.ops.kernels import topk as ptk
# pytest puts tests/ itself on sys.path; the card's machine may have a
# top-level package named `tests` of its own
from torch_port_common import beam_step_case  # noqa: E402

pytestmark = pytest.mark.cuda
NEG = -1.0e30


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tt,d", [(100, 16), (384, 64)])
def test_flash_kernel_matches_plain(dev, dtype, tol, tt, d):
    g = _gen(tt)
    n = 6
    q, k, v = (torch.randn(n, tt, d, generator=g).to(dtype) for _ in range(3))
    lens = torch.tensor([tt, tt - 9, tt // 2, 1, tt, 7])
    bias = torch.where(torch.arange(tt)[None] < lens[:, None], 0.0, NEG)
    want, want_lse = pfa.flash_attention_plain(q, k, v, bias, d ** -0.5)
    got, lse = pfa.flash_attention_fwd(*(x.to(dev) for x in (q, k, v, bias)),
                                       d ** -0.5)
    torch.cuda.synchronize()
    assert (got.float().cpu() - want.float()).abs().max() <= tol
    assert (lse.cpu() - want_lse).abs().max() <= 1e-3


@pytest.mark.parametrize("pos", [0, 37, 63, 80])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,k,dh", [(3, 3, 64), (2, 5, 32), (1, 1, 128)])
def test_decode_kernel_matches_plain(dev, pos, dtype, tol, b, k, dh):
    g = _gen(pos)
    s_max, heads = 64, 4
    n, c = b * k, heads * dh
    q = torch.randn(n, c, generator=g).to(dtype)
    kv = torch.randn(n, s_max, 2 * c, generator=g).to(dtype)
    row = torch.randn(n, 2 * c, generator=g).to(dtype)
    anc = torch.randint(0, k, (s_max, b, k), generator=g)
    anc[min(pos, s_max - 1)] = torch.arange(k)
    valid = (torch.arange(s_max) <= pos)[:, None, None, None] & (
        anc[..., None] == torch.arange(k))
    bias = torch.where(valid.permute(1, 2, 0, 3), 0.0, NEG).contiguous()
    want, want_kv = pda.decode_attention_plain(pos, q, kv.clone(), bias, k,
                                               heads, row)
    kv_d = kv.to(dev)
    got, got_kv = pda.decode_attention(pos, q.to(dev), kv_d, bias.to(dev), k,
                                       heads, row.to(dev))
    torch.cuda.synchronize()
    assert got_kv is kv_d
    assert torch.equal(got_kv.cpu(), want_kv)  # the written row, bit-exact
    assert (got.float().cpu() - want.float()).abs().max() <= tol


@pytest.mark.parametrize("rows,v,k", [(24, 5049, 4), (8, 15, 3)])
def test_topk_kernel_matches_plain(dev, rows, v, k):
    x = torch.randn(rows, v, generator=_gen(v))
    x[:, v // 2] = x.amax(dim=1)  # ties with the row max
    x[1] = 0.25
    want_v, want_i = ptk.topk_plain(x, k)
    got_v, got_i = ptk.topk_lastdim(x.to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu(), want_v)


@pytest.mark.parametrize("tt,c", [(384, 96), (375, 7), (1, 5), (64, 300)])
def test_cumlogsumexp_kernel_matches_plain(dev, tt, c):
    """Drifting columns, -inf prefixes and an all -inf column. The kernel
    sums in sequential order, the twin as a tree: within 1e-4 + 1e-6|x|
    (T rescale-and-add steps of a few ulps each), -inf exactly."""
    g = _gen(tt + c)
    x = torch.randn(tt, c, generator=g) * 3.0
    x = x - 8.5 * torch.arange(tt)[:, None].flip(0)
    x[: tt // 2, : c // 3] = float("-inf")
    x[:, -1] = float("-inf")
    want = psl.cumlogsumexp_plain(x)
    got = psl.cumlogsumexp(x.to(dev)).cpu()
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert not torch.isnan(got).any()
    fin = torch.isfinite(want)
    assert ((got[fin] - want[fin]).abs()
            <= 1e-4 + 1e-6 * want[fin].abs()).all()


@pytest.mark.parametrize("r,c,n", [(8 * 5049, 384, 96), (50, 37, 9)])
def test_row_gather_kernel_matches_plain(dev, r, c, n):
    """Exact, with 16-byte copies (c % 4 == 0) and without; an index out
    of range gives a NaN row."""
    src = torch.randn(r, c, generator=_gen(c))
    idx = torch.randint(0, r, (n,), generator=_gen(n))
    idx[0] = r - 1
    got = prg.row_gather(src.to(dev), idx.to(dev)).cpu()
    assert torch.equal(got, prg.row_gather_plain(src, idx))
    bad = prg.row_gather(src.to(dev), torch.tensor([r], device=dev)).cpu()
    assert torch.isnan(bad).all()


@pytest.mark.parametrize("use_ctc,dyadic", [(True, False), (False, False),
                                            (True, True)])
@pytest.mark.parametrize("seed,i", [(0, 4), (1, 9), (2, 17)])
def test_beam_update_kernel_matches_plain(dev, seed, i, use_ctc, dyadic):
    """Every output bit-identical to the twin on the same step states
    (forced step, stopped lane, ties, eos among the pre-beam ids)."""
    w_ctc = 0.1 if use_ctc else 0.0
    kw = dict(w_dec=1.0 - w_ctc, w_ctc=w_ctc, eos=49, neg=-1.0e30,
              d_end=-10.0, m_end=3)
    args = [None if x is None else torch.from_numpy(x)
            for x in beam_step_case(seed, i, use_ctc=use_ctc,
                                    dyadic=dyadic).values()]
    want = pbu.beam_update_plain(i, *args, **kw)
    got = pbu.beam_update(i, *(None if x is None else x.to(dev)
                               for x in args), **kw)
    torch.cuda.synchronize()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name].cpu(), w), name


def _attn_case(dev, n, tt, d, dtype, seed):
    g = _gen(seed)
    q, k, v, do = (torch.randn(n, tt, d, generator=g).to(dtype)
                   for _ in range(4))
    lens = torch.tensor([tt, tt - 9, tt // 2, 1, tt, 7])[:n].clamp_min(1)
    bias = torch.where(torch.arange(tt)[None] < lens[:, None], 0.0, NEG)
    return [x.to(dev) for x in (q, k, v, bias, do)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tt,d", [(100, 16), (77, 32), (384, 64), (130, 128)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bwd_kernels_match_plain(dev, dtype, tol, tt, d, rate):
    """The forward with and without dropout, and the dq (with delta) and
    dkv kernels against the plain twins on the same inputs and seed:
    within ``tol`` of each output's largest entry (fp32 sums in another
    order; bf16: the same roundings of P~ and dS, two ulps at the top)."""
    q, k, v, bias, do = _attn_case(dev, 6, tt, d, dtype, tt + d)
    seed = (11, 22) if rate else None
    sc = d ** -0.5
    out, lse = pfa.flash_attention_fwd(q, k, v, bias, sc, rate, seed)
    dq, delta = pfa.flash_attention_bwd_dq(q, k, v, bias, out, do, lse, sc,
                                           rate, seed)
    dk, dv = pfa.flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta, sc,
                                         rate, seed)
    w_out, w_lse = pfa.flash_attention_plain(q, k, v, bias, sc,
                                             dropout_rate=rate,
                                             dropout_seed=seed)
    wants = pfa.flash_attention_bwd_plain(q, k, v, bias, out, do, lse, sc,
                                          dropout_rate=rate,
                                          dropout_seed=seed)
    torch.cuda.synchronize()
    assert (lse - w_lse).abs().max() <= 1e-3
    assert (delta - pfa.attention_delta_plain(out, do)).abs().max() <= 1e-3
    for got, want in zip((out, dq, dk, dv), (w_out, *wants)):
        scale = want.float().abs().max()
        assert (got.float() - want.float()).abs().max() <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dropout_mask_is_the_twins(dev, dtype):
    """The forward kernel's keep mask, read out with uniform attention
    (q = k = 0) and V = T x identity blocks, is dropout_keep_mask_plain's
    bit for bit; two calls agree; the output is linear in V."""
    n, tt, d, rate, seed = 4, 160, 32, 0.1, (5, 6)
    z = torch.zeros(n, tt, d, device=dev, dtype=dtype)
    bias = torch.zeros(n, tt, device=dev)
    cols = []
    for j0 in range(0, tt, d):
        vb = torch.zeros(n, tt, d, device=dev)
        vb[:, j0:j0 + d] = torch.eye(d, device=dev) * tt
        cols.append(pfa.flash_attention_fwd(z, z, vb.to(dtype), bias, 1.0,
                                            rate, seed)[0].float())
    got = torch.cat(cols, dim=2) > 0.5
    want = pfa.dropout_keep_mask_plain(seed, n, tt, rate, dev)
    assert torch.equal(got, want)
    q, k, v, bias, _ = _attn_case(dev, 4, tt, d, torch.float32, 3)
    a = pfa.flash_attention_fwd(q, k, v, bias, 0.2, rate, seed)[0]
    b = pfa.flash_attention_fwd(q, k, v, bias, 0.2, rate, seed)[0]
    c = pfa.flash_attention_fwd(q, k, 2 * v, bias, 0.2, rate, seed)[0]
    assert torch.equal(a, b)
    assert (c - 2 * a).abs().max() <= 1e-5


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_fn_grads_cuda_match_cpu(dev, rate):
    """FlashAttentionFn through mha_flash on the card (kernels) against the
    same call on the CPU (twins), fp32, with padding and dropout at the
    same seed: out and dQ/dK/dV within 1e-4; the kernels counted."""
    g = _gen(9)
    b, tt, h, dh = 2, 70, 4, 16
    x = [torch.randn(b, tt, h, dh, generator=g) for _ in range(4)]
    mask = torch.arange(tt)[None] < torch.tensor([[tt], [50]])
    res = {}
    before = (pfa.flash_attention_fwd.launches,
              pfa.flash_attention_bwd_dq.launches,
              pfa.flash_attention_bwd_dkv.launches)
    for where in ("cpu", dev):
        q, k, v = (y.to(where, copy=True).requires_grad_() for y in x[:3])
        out = pfa.mha_flash(q, k, v, mask.to(where), 0.25, dropout_rate=rate,
                            dropout_seed=(3, 4) if rate else None)
        out.backward(x[3].to(where))
        res[str(where)] = [y.detach().cpu() for y in (out, q.grad, k.grad,
                                                      v.grad)]
    torch.cuda.synchronize()
    for a, c in zip(res["cpu"], res[str(dev)]):
        assert (a - c).abs().max() <= 1e-4
    assert (pfa.flash_attention_fwd.launches - before[0],
            pfa.flash_attention_bwd_dq.launches - before[1],
            pfa.flash_attention_bwd_dkv.launches - before[2]) == (1, 1, 1)
