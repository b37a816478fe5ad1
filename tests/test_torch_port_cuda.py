"""The port's CUDA kernels vs their plain twins, on an NVIDIA GPU.

Marked ``cuda``; every test skips where torch sees no CUDA device. Imports
torch and numpy only, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import pytest
import torch

from avsr_tpu_torch.ops.kernels import beam_update as pbu
from avsr_tpu_torch.ops.kernels import ctc_loss as pcl
from avsr_tpu_torch.ops.kernels import decode_attention as pda
from avsr_tpu_torch.ops.kernels import decoder_layer as pdl
from avsr_tpu_torch.ops.kernels import flash_attention as pfa
from avsr_tpu_torch.ops.kernels import row_gather as prg
from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl
from avsr_tpu_torch.ops.kernels import stem_fuse as psf
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


@pytest.mark.parametrize("pos", [0, 37, 63, 80, 191])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,k,dh", [(3, 3, 64), (2, 5, 32), (1, 1, 128),
                                    (2, 8, 64)])
@pytest.mark.parametrize("s_max", [64, 192])
def test_decode_kernel_matches_plain(dev, pos, dtype, tol, b, k, dh, s_max):
    """Over a cluster of the launch plan's size (2; at pos 0 a rank may
    hold no row), the written row and the whole cache bit-exact, pos >= S
    clamped to S-1."""
    g = _gen(pos)
    heads = 4
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


@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("pos", [0, 100, 191, 250])
def test_decode_kernel_within_the_output_bound(dev, b, pos):
    """At the serving widths (K=3, H=16, dh=64, S=192, a bf16 cache, q
    scaled as the decoder scales it), B=8 and B=32: the bf16 output and the
    unrounded one (q given in fp32) within ``output_bound`` of the twin's,
    element by element (ROADMAP C27), and the bf16 output the fp32 one
    rounded, bit for bit."""
    k, heads, dh, s_max = 3, 16, 64, 192
    g = _gen(b + pos)
    n, c = b * k, heads * dh
    q = (torch.randn(n, c, generator=g) * dh ** -0.5).to(torch.bfloat16)
    kv = torch.randn(n, s_max, 2 * c, generator=g).to(torch.bfloat16)
    row = torch.randn(n, 2 * c, generator=g).to(torch.bfloat16)
    anc = torch.randint(0, k, (s_max, b, k), generator=g)
    anc[min(pos, s_max - 1)] = torch.arange(k)
    valid = (torch.arange(s_max) <= pos)[:, None, None, None] & (
        anc[..., None] == torch.arange(k))
    bias = torch.where(valid.permute(1, 2, 0, 3), 0.0, NEG).contiguous()
    outs = {}
    for qq in (q, q.float()):
        want, _ = pda.decode_attention_plain(pos, qq, kv.clone(), bias, k,
                                             heads, row)
        got, _ = pda.decode_attention(pos, qq.to(dev), kv.to(dev),
                                      bias.to(dev), k, heads, row.to(dev))
        torch.cuda.synchronize()
        bound = pda.output_bound(pos, qq, kv, bias, k, heads, row)
        diff = (got.float().cpu() - want.float()).abs()
        assert (diff <= bound).all(), float((diff / bound).max())
        outs[qq.dtype] = got.cpu()
    assert torch.equal(outs[torch.bfloat16],
                       outs[torch.float32].to(torch.bfloat16))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("qdtype,cdtype", [(torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.float32)])
def test_decode_kernel_every_cluster_size(dev, cluster, qdtype, cdtype):
    """Each cluster size G, forced, at the serving head width (B=8, K=3,
    H=16, dh=64, S=192; S=1000 for G=1, whose chunk takes several
    tiles), the mixed dtype pairs, and pos 0, 100, 250: cache bit-exact,
    out within 2e-2 (bf16 p) of the twin, one launch each."""
    b, k, heads, dh = 8, 3, 16, 64
    s_max = 1000 if cluster == 1 else 192
    g = _gen(cluster)
    n, c = b * k, heads * dh
    for pos in (0, 100, 250):
        q = (torch.randn(n, c, generator=g) * 0.125).to(qdtype)
        kv = torch.randn(n, s_max, 2 * c, generator=g).to(cdtype)
        row = torch.randn(n, 2 * c, generator=g).to(cdtype)
        anc = torch.randint(0, k, (s_max, b, k), generator=g)
        anc[min(pos, s_max - 1)] = torch.arange(k)
        valid = (torch.arange(s_max) <= pos)[:, None, None, None] & (
            anc[..., None] == torch.arange(k))
        bias = torch.where(valid.permute(1, 2, 0, 3), 0.0, NEG).contiguous()
        want, want_kv = pda.decode_attention_plain(pos, q, kv.clone(), bias,
                                                   k, heads, row)
        kv_d = kv.to(dev)
        before = pda.decode_attention.launches
        got, _ = pda._launch(pos, q.to(dev), kv_d, bias.to(dev), k, heads,
                             row.to(dev), cluster)
        torch.cuda.synchronize()
        assert pda.decode_attention.launches == before + 1
        assert torch.equal(kv_d.cpu(), want_kv)
        assert (got.float().cpu() - want.float()).abs().max() <= 2e-2


@pytest.mark.parametrize("rows,v,k", [(24, 5049, 4), (96, 5049, 4),
                                      (8, 15, 3), (32, 15, 3), (5, 1025, 8),
                                      (3, 1024, 9), (40, 5049, 32)])
def test_topk_kernel_matches_plain(dev, rows, v, k):
    """The beam's shapes (block or cluster a vocabulary row at 24 and 96
    rows, a warp a row for the flat (B, 15) top-k), both routes' edges, and
    k across the register lists' sizes; ties with the row max, a row of
    equal values. Rows of up to 1024 columns take the warp kernel."""
    x = torch.randn(rows, v, generator=_gen(v))
    x[:, v // 2] = x.amax(dim=1)  # ties with the row max
    x[1] = 0.25
    want_v, want_i = ptk.topk_plain(x, k)
    before = (ptk.topk_lastdim.launches, ptk.topk_lastdim.flat_launches)
    got_v, got_i = ptk.topk_lastdim(x.to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu(), want_v)
    assert (ptk.topk_lastdim.launches - before[0],
            ptk.topk_lastdim.flat_launches - before[1]) == (1, int(v <= 1024))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("v,k", [(5049, 4), (15, 3), (2000, 17)])
def test_topk_kernel_edge_rows(dev, offset, v, k):
    """Rows that start off a 16-byte boundary (the tensor's storage offset
    and v = 5049 put each row's head elsewhere); rows with fewer than k
    entries above -inf, where a round repeats an earlier index (-inf at
    high and at low columns, a row all -inf); rows of equal values; +inf
    entries."""
    rows = 24
    g = _gen(v + offset)
    buf = torch.randn(rows * v + offset, generator=g)
    x = buf[offset:].view(rows, v)
    x[0] = float("-inf")
    x[1] = float("-inf")
    x[1, v - 1] = 2.0
    x[2, :] = float("-inf")
    x[2, 0] = -3.0
    x[2, v // 2] = 1.0
    x[3] = 7.5
    x[4, v // 3] = float("inf")
    x[4, v - 2] = float("inf")
    x[5, : v // 2] = float("-inf")
    x[5, v - 1] = float("-inf")
    x[5, v // 2 + 1:v - 1] = float("-inf")
    want_v, want_i = ptk.topk_plain(x, k)
    xd = torch.randn(rows * v + offset).to(dev)
    xd[offset:] = buf[offset:].to(dev)
    got_v, got_i = ptk.topk_lastdim(xd[offset:].view(rows, v), k)
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu(), want_v)


@pytest.mark.parametrize("tt,c", [(384, 96), (375, 7), (1, 5), (64, 300),
                                  (384, 384), (700, 33)])
def test_cumlogsumexp_kernel_matches_plain(dev, tt, c):
    """Drifting columns, -inf prefixes and an all -inf column; T past one
    384-row chunk carries. The kernel's scan and the twin's tree combine
    in other orders: within 1e-4 + 1e-6|x|, -inf exactly."""
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


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("k,sp,ll,s_rows", [(3, 4, 377, 192), (3, 4, 30, 16),
                                            (16, 7, 377, 192),
                                            (4, 31, 60, 40)])
def test_beam_update_kernel_at_every_batch_and_its_limits(dev, b, k, sp, ll,
                                                          s_rows):
    """Every output bit-identical to the twin at B=1, 8 and 32, at the
    serving shape (K=3, 15 candidates, L=377 and a 192-row ancestry: five
    blocks an utterance), at one block an utterance, and at the kernel's
    limits (K=16 with 128 candidates; K=4 with 128)."""
    kw = dict(w_dec=0.9, w_ctc=0.1, eos=60, neg=NEG, d_end=-10.0, m_end=3)
    case = beam_step_case(b, 20, b=max(b, 6), k=k, sp=sp, ll=ll,
                          s_rows=s_rows, eos=60)
    args = [torch.from_numpy(x) for x in case.values()]
    args = [(x[:, :b] if name == "anc" else x[:b]).contiguous()
            for name, x in zip(case, args)]
    want = pbu.beam_update_plain(20, *args, **kw)
    got = pbu.beam_update(20, *(x.to(dev) for x in args), **kw)
    torch.cuda.synchronize()
    for name, w in want.items():
        assert torch.equal(got[name].cpu(), w), name


@pytest.mark.parametrize("k,sp", [(100, 200), (250, 250)])
def test_beam_update_kernel_refuses_beyond_its_limits(dev, k, sp):
    """More listed candidates (min(K, 128) of each chunk of 128, 24 bytes
    each) than a block's shared memory holds beside one item's tile (the
    wide kernel's limit, some 9,000 candidates at K >= 128): the kernel
    refuses the launch, and the wrapper raises. (Beyond 16 hypotheses or
    128 candidates the wide kernel runs, 60,003 candidates of three
    hypotheses included: test_beam_update_wide_kernel_matches_plain.)"""
    b, ll = 2, 30
    z = torch.zeros
    args = [torch.full((b,), 20, dtype=torch.int64), z(b, k, sp), z(b, k),
            z(b, k, sp), z(b, k), z(b, k),
            torch.ones(b, k, sp, dtype=torch.int64), z(b, k),
            torch.ones(b, k, dtype=torch.bool), z(b, dtype=torch.bool),
            z(b, k, ll, dtype=torch.int64), z(8, b, k, dtype=torch.int64),
            z(b, ll), z(b, ll, dtype=torch.int64), z(b),
            z(b, ll, dtype=torch.int64), z(b, dtype=torch.int64)]
    with pytest.raises(RuntimeError, match="beam_update"):
        pbu.beam_update(5, *(x.to(dev) for x in args), w_dec=0.9, w_ctc=0.1,
                        eos=1, neg=NEG, d_end=-10.0, m_end=3)


# ROADMAP C28: the top-k's k > 32 kernel and beam_update's block kernel,
# just under and just over the fast paths' limits


@pytest.mark.parametrize("lanes", [8, 9, 16, 22, 32, 64, 100])
@pytest.mark.parametrize("pos", [0, 100, 191, 250])
@pytest.mark.parametrize("qdtype,cdtype", [(torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float32)])
def test_decode_wide_kernel_within_the_output_bound(dev, lanes, pos, qdtype,
                                                    cdtype):
    """Just under (8 lanes: one query tile) and over (9-64: up to eight
    query tiles, one read of the prefix; 100: two query groups of 50) the
    one-tile limit, at the model's heads (H=16, dh=64) over a 192-row
    cache (64 and 100 lanes at pos >= 64: two passes over chunks of the
    rank's rows, as the launch plan says): the cache the twin's bit for
    bit, out within ``output_bound`` (ROADMAP C27) with a bf16 cache,
    within 1e-4 with an fp32 one (as test_decode_kernel_matches_plain: the
    bound covers p's rounding to bf16, not the scores' fp32 sums in another
    order); the wide count moves only beyond 8 lanes."""
    from torch_port_common import decode_case

    b, heads = 2, 16
    q, kv, row, bias = (torch.from_numpy(x).contiguous() for x in decode_case(
        pos + lanes, b=b, k=lanes, s_max=192, heads=heads, dh=64, pos=pos,
        q_scale=0.125))
    q, kv, row = q.to(qdtype), kv.to(cdtype), row.to(cdtype)
    want, want_kv = pda.decode_attention_plain(pos, q, kv.clone(), bias,
                                               lanes, heads, row)
    bnd = pda.output_bound(pos, q, kv, bias, lanes, heads, row)
    before = pda.decode_attention.wide_launches
    got, got_kv = pda.decode_attention(pos, q.to(dev), kv.to(dev),
                                       bias.to(dev), lanes, heads,
                                       row.to(dev))
    torch.cuda.synchronize()
    assert pda.decode_attention.wide_launches - before == int(lanes > 8)
    assert torch.equal(got_kv.cpu(), want_kv)
    diff = (got.float().cpu() - want.float()).abs()
    if cdtype == torch.float32:
        bnd = torch.full_like(diff, 1e-4)
    assert bool((diff <= bnd).all()), float((diff / bnd).max())


@pytest.mark.parametrize("lanes,cluster,chunk", [(22, 2, 64), (22, 4, 16),
                                                 (9, 1, 32), (40, 8, 48)])
@pytest.mark.parametrize("cdtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_two_passes(dev, lanes, cluster, chunk, cdtype):
    """A launch plan forced to hold the scores of only ``chunk`` rows at a
    time (two passes, the keys read twice), at B=2, H=16, dh=64, S=192,
    pos 150: the same cache and an output within ``output_bound`` (bf16)
    or 1e-4 (fp32), as the one-pass plan's."""
    from torch_port_common import decode_case

    b, heads, pos = 2, 16, 150
    q, kv, row, bias = (torch.from_numpy(x).contiguous() for x in decode_case(
        lanes + chunk, b=b, k=lanes, s_max=192, heads=heads, dh=64, pos=pos,
        q_scale=0.125))
    kv, row = kv.to(cdtype), row.to(cdtype)
    esize = kv.element_size()
    plan = pda.launch_plan(b, lanes, heads, 64, 192, esize, cluster)
    tile = min(chunk, plan.rows_per_rank)
    plan = plan._replace(tile=tile, chunk=chunk,
                         smem=pda.smem_bytes(plan.group_lanes, 64, esize,
                                             chunk, tile))
    assert plan.chunk < plan.rows_per_rank
    want, want_kv = pda.decode_attention_plain(pos, q, kv.clone(), bias,
                                               lanes, heads, row)
    bnd = pda.output_bound(pos, q, kv, bias, lanes, heads, row)
    got, got_kv = pda._launch(pos, q.to(dev), kv.to(dev), bias.to(dev),
                              lanes, heads, row.to(dev), plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got_kv.cpu(), want_kv)
    diff = (got.float().cpu() - want.float()).abs()
    if cdtype == torch.float32:
        bnd = torch.full_like(diff, 1e-4)
    assert bool((diff <= bnd).all()), float((diff / bnd).max())


# B2's fp32 instance: q.k and P.V in split TF32 on the tensor cores, with
# the model's 64-wide heads


def _tf32_case(lanes, pos, b, c, heads, qdtype, seed):
    """An fp32 cache's decode step at the conformer's (C=768, 12 heads) or
    the flagship's (C=1024, 16 heads) widths over a 192-row cache, the
    queries scaled as the decoder scales them."""
    from torch_port_common import decode_case

    q, kv, row, bias = (torch.from_numpy(x).contiguous() for x in decode_case(
        seed, b=b, k=lanes, s_max=192, heads=heads, dh=c // heads, pos=pos,
        q_scale=0.125))
    return q.to(qdtype), kv, row, bias


@pytest.mark.parametrize("lanes", [1, 3, 8, 10, 22])
@pytest.mark.parametrize("pos", [0, 5, 191, 250])
@pytest.mark.parametrize("c,heads", [(768, 12), (1024, 16)])
def test_decode_tf32_kernel_within_the_output_bound(dev, lanes, pos, c,
                                                    heads):
    """An fp32 cache with dh = 64 at 1-22 lanes (one to three query
    tiles), B=2, over a 192-row cache, at the launch plan's cluster size:
    the cache the twin's bit for bit after the row write (pos >= S clamped
    to S-1), out within ``output_bound`` (ROADMAP C27) of the twin's with
    q in fp32 and in bf16, one launch each, counted in ``tf32_launches``
    (and in ``wide_launches`` beyond 8 lanes)."""
    for qdtype in (torch.float32, torch.bfloat16):
        q, kv, row, bias = _tf32_case(lanes, pos, 2, c, heads, qdtype,
                                      lanes + pos)
        want, want_kv = pda.decode_attention_plain(pos, q, kv.clone(), bias,
                                                   lanes, heads, row)
        bnd = pda.output_bound(pos, q, kv, bias, lanes, heads, row)
        fn = pda.decode_attention
        before = (fn.launches, fn.tf32_launches, fn.wide_launches)
        kv_d = kv.to(dev)
        got, got_kv = pda.decode_attention(pos, q.to(dev), kv_d,
                                           bias.to(dev), lanes, heads,
                                           row.to(dev))
        torch.cuda.synchronize()
        assert got_kv is kv_d
        assert (fn.launches - before[0], fn.tf32_launches - before[1],
                fn.wide_launches - before[2]) == (1, 1, int(lanes > 8))
        assert torch.equal(got_kv.cpu(), want_kv)
        diff = (got.float().cpu() - want.float()).abs()
        assert bool((diff <= bnd).all()), float((diff / bnd).max())


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("lanes", [3, 22])
def test_decode_tf32_kernel_every_cluster_size(dev, cluster, lanes):
    """Each cluster size G, forced, at C=768 with 12 heads, B=8 and an
    fp32 cache, pos 0, 5, 191 and 250: cache bit-exact, out within
    ``output_bound`` of the twin, one tf32 launch each."""
    for pos in (0, 5, 191, 250):
        q, kv, row, bias = _tf32_case(lanes, pos, 8, 768, 12, torch.float32,
                                      cluster + pos)
        want, want_kv = pda.decode_attention_plain(pos, q, kv.clone(), bias,
                                                   lanes, 12, row)
        bnd = pda.output_bound(pos, q, kv, bias, lanes, 12, row)
        kv_d = kv.to(dev)
        before = pda.decode_attention.tf32_launches
        got, _ = pda._launch(pos, q.to(dev), kv_d, bias.to(dev), lanes, 12,
                             row.to(dev), cluster)
        torch.cuda.synchronize()
        assert pda.decode_attention.tf32_launches == before + 1
        assert torch.equal(kv_d.cpu(), want_kv)
        diff = (got.cpu() - want).abs()
        assert bool((diff <= bnd).all()), float((diff / bnd).max())


def test_decode_fp32_counts_only_the_tf32_heads(dev):
    """Heads other than 64 wide take the CUDA-core instance:
    ``tf32_launches`` does not move for dh = 32 or 128, nor for a bf16
    cache, nor where ``cuda_cores`` forces that instance at dh = 64 (the
    yardstick chip_smoke times), whose output stays within
    ``output_bound`` of the twin."""
    for dh, dtype, simt in ((32, torch.float32, False),
                            (128, torch.float32, False),
                            (64, torch.bfloat16, False),
                            (64, torch.float32, True)):
        q, kv, row, bias = _tf32_case(3, 37, 2, 4 * dh, 4, dtype, dh)
        kv, row = kv.to(dtype), row.to(dtype)
        want, want_kv = pda.decode_attention_plain(37, q, kv.clone(), bias,
                                                   3, 4, row)
        bnd = pda.output_bound(37, q, kv, bias, 3, 4, row)
        before = pda.decode_attention.tf32_launches
        kv_d = kv.to(dev)
        got, _ = pda._launch(37, q.to(dev), kv_d, bias.to(dev), 3, 4,
                             row.to(dev), cuda_cores=simt)
        torch.cuda.synchronize()
        assert pda.decode_attention.tf32_launches == before
        assert torch.equal(kv_d.cpu(), want_kv)
        if dtype == torch.float32:
            diff = (got.cpu() - want).abs()
            assert bool((diff <= bnd).all()), float((diff / bnd).max())


@pytest.mark.parametrize("rows,v,k", [(44, 5049, 32), (44, 5049, 33),
                                      (8, 726, 22), (8, 726, 33),
                                      (3, 100, 100), (5, 1025, 64)])
def test_topk_wide_kernel_matches_plain(dev, rows, v, k):
    """Beam 22's pre-beam (B*22, 5049) at k = 32 (the list kernel) and 33
    (the rounds kernel), its flat (B, 22*33) top-k at k = 22 and 33, k = v,
    and a 1025-column row; ties with the row max, equal values, a row of
    -inf with one finite entry, a row all -inf. Exact, and the wide count
    moves only for k > 32."""
    x = torch.randn(rows, v, generator=_gen(v + k))
    x[:, v // 2] = x.amax(dim=1)
    x[1] = 0.25
    x[2] = float("-inf")
    x[2, v - 1] = 1.5
    if rows > 3:
        x[3] = float("-inf")
    want_v, want_i = ptk.topk_plain(x, k)
    before = (ptk.topk_lastdim.launches, ptk.topk_lastdim.wide_launches)
    got_v, got_i = ptk.topk_lastdim(x.to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu(), want_v)
    assert (ptk.topk_lastdim.launches - before[0],
            ptk.topk_lastdim.wide_launches - before[1]) == (1, int(k > 32))


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("k", [32, 33, 48, 64])
def test_topk_wide_kernel_edge_rows(dev, offset, k):
    """k = 32 (the list kernel) and 33, 48, 64 (the radix select) on rows
    off a 16-byte boundary with fewer than k entries above -inf (the -inf
    rule repeats an index), +inf entries, a row of equal values, ties at
    the k-th value and a row of a few distinct values."""
    rows, v = 8, 5049
    buf = torch.randn(rows * v + offset, generator=_gen(offset))
    x = buf[offset:].view(rows, v)
    x[0] = float("-inf")
    x[1] = float("-inf")
    x[1, [0, v // 2, v - 1]] = torch.tensor([-3.0, 1.0, 2.0])
    x[2] = 7.5
    x[3, v // 3] = float("inf")
    x[3, v - 2] = float("inf")
    x[4, 40:] = float("-inf")
    x[5, ::7] = x[5].amax()  # 722 entries tie at the row's max
    x[6] = torch.randint(0, 4, (v,), generator=_gen(k)).float()
    want_v, want_i = ptk.topk_plain(x, k)
    got_v, got_i = ptk.topk_lastdim(x.to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu(), want_v)


@pytest.mark.parametrize("k", [33, 64, 5049])
def test_topk_wide_kernel_skips_nan(dev, k):
    """NaN is never chosen (C1): rows with NaNs, one with fewer than k
    entries that are not NaN, one all NaN, against the k rounds of C1's
    rule with NaN left out (``c1_topk``); k = v included."""
    from torch_port_common import c1_topk

    rows, v = 6, 5049
    x = torch.randn(rows, v, generator=_gen(k))
    x[0, ::3] = float("nan")
    x[1] = float("nan")
    x[1, [5, 9, 4000]] = torch.tensor([1.0, float("-inf"), -2.0])
    x[2] = float("nan")
    x[3, :100] = float("nan")
    x[3, 100:] = float("-inf")
    x[3, 2000] = 3.0
    x[4, 1::2] = float("nan")
    x[4, ::4] = 0.5
    got_v, got_i = ptk.topk_lastdim(x.to(dev), k)
    torch.cuda.synchronize()
    want_v, want_i = c1_topk(x.numpy(), k)
    assert (got_i.cpu().numpy() == want_i).all()
    assert (got_v.cpu().numpy() == want_v).all()


def test_topk_wide_kernel_refuses_beyond_its_limit(dev):
    """Rows whose keys and sort buffer overflow shared memory at k > 32
    raise ValueError naming the limit; the list kernel takes them at k =
    32."""
    x = torch.randn(2, 60000, device=dev)
    assert ptk.wide_smem_bytes(60000, 33) > ptk.WIDE_SMEM_MAX
    with pytest.raises(ValueError, match=str(ptk.WIDE_SMEM_MAX)):
        ptk.topk_lastdim(x, 33)
    vals, _ = ptk.topk_lastdim(x, 32)
    assert torch.equal(vals, torch.topk(x, 32).values)


def _all_inf_lanes(case):
    """Lane 6's candidates all -inf (every round takes index 0), lane 7's
    all -inf but hypothesis 1's eos slot (the later rounds take index 0,
    not chosen before)."""
    for name in ("dec_top", "dec_eos"):
        case[name][6:8] = float("-inf")
    case["dec_eos"][7, 1] = -1.0
    return case


@pytest.mark.parametrize("k,sp", [(16, 7), (17, 7), (3, 41), (3, 42),
                                  (10, 15), (22, 33), (17, 4), (3, 43),
                                  (30, 45), (40, 60), (3, 20000)])
@pytest.mark.parametrize("use_ctc", [True, False])
@pytest.mark.parametrize("b", [8, 32])
def test_beam_update_wide_kernel_matches_plain(dev, k, sp, use_ctc, b):
    """Just under (16 hypotheses, 128 candidates: the warp kernel) and just
    over (17 hypotheses, 129 candidates) the warp kernel's limits, beam 10
    (S'=15) and beam 22 (S'=33), two shapes the warp kernel once refused
    ((17, 4), (3, 43)), beam 30 (1380 candidates: warps take a second
    chunk), 40 hypotheses (two trips of warp 0's bookkeeping) and 60,003
    candidates of three hypotheses, at B=8 and B=32, with two lanes whose
    candidates are all -inf (or all but one): every output bit-identical
    to the twin, and the wide count moves only beyond the limits."""
    w_ctc = 0.1 if use_ctc else 0.0
    eos = max(60, sp + 2)  # S' distinct ids below eos
    kw = dict(w_dec=1.0 - w_ctc, w_ctc=w_ctc, eos=eos, neg=NEG, d_end=-10.0,
              m_end=3)
    for seed, i in ((k, 9), (sp, 20)):
        case = beam_step_case(seed, i, use_ctc=use_ctc, b=b, k=k, sp=sp,
                              ll=377, s_rows=192, eos=eos)
        if seed == k:
            case = _all_inf_lanes(case)
        args = [None if x is None else torch.from_numpy(x)
                for x in case.values()]
        want = pbu.beam_update_plain(i, *args, **kw)
        before = pbu.beam_update.wide_launches
        got = pbu.beam_update(i, *(None if x is None else x.to(dev)
                                   for x in args), **kw)
        torch.cuda.synchronize()
        assert pbu.beam_update.wide_launches - before == int(
            k > 16 or k * (sp + 1) > 128)
        for name, w in want.items():
            assert torch.equal(got[name].cpu(), w), name


@pytest.mark.parametrize("b,lanes,v,k,tp,offset", [
    (8, 3, 5049, 4, 384, 0), (32, 3, 5049, 4, 384, 0),
    (32, 22, 5049, 33, 128, 0), (8, 3, 5049, 4, 127, 0),
    (8, 3, 5049, 4, 384, 1), (4, 22, 5049, 33, 131, 3),
    (6, 3, 61, 4, 20, 0), (2, 5, 1025, 8, 36, 2)])
def test_topk_gather_rows_kernel_matches_plain(dev, b, lanes, v, k, tp,
                                               offset):
    """The pre-beam top-k with the CTC rows gathered in its launch, against
    ``topk_plain`` then ``row_gather_plain`` of rows b*V + id, bit for bit:
    the beam's pre-beam at B=8 and B=32 (beam 3, k=4, Tp=384) and beam 22's
    at B=32 (k=33, Tp=128: the radix select), a row length Tp that is not
    a multiple of 4, a table 1 or 3 floats off a 16-byte boundary (single
    floats copied), a short vocabulary (the warp-a-row kernel) and a
    1025-column one; rows with ties at the maximum. A row of NaN, whose
    ids lie outside [0, V) (C1's rule: 2**31 - 1), gathers rows of NaN.
    One launch each, counted by the top-k, the gather and the wide
    counters."""
    from torch_port_common import c1_topk

    g = _gen(v + k + tp + offset)
    x = torch.randn(b, lanes, v, generator=g)
    x[..., v // 2] = x.amax(dim=-1)
    x[1, 0] = 0.25
    x[0, lanes - 1] = float("nan")
    buf = torch.randn(b * v * tp + offset, generator=g)
    table = buf[offset:].view(b * v, tp)
    vals, ids = ptk.topk_plain(x, k)
    want_v, want_i = c1_topk(x[0, lanes - 1:].numpy(), k)
    vals[0, lanes - 1], ids[0, lanes - 1] = (torch.from_numpy(want_v[0]),
                                            torch.from_numpy(want_i[0]))
    base = (torch.arange(b) * v)[:, None, None]
    keep = (ids >= 0) & (ids < v)
    want_rows = prg.row_gather_plain(table, torch.where(
        keep, ids + base, 0).view(-1))
    want_rows[~keep.view(-1)] = float("nan")
    tb, xb, tbd = table.to(dev), x.to(dev), buf.to(dev)
    if offset:
        tb = tbd[offset:].view(b * v, tp)
    counts = (ptk.topk_lastdim.launches, ptk.topk_lastdim.gather_launches,
              ptk.topk_lastdim.wide_launches, ptk.topk_gather_rows.launches)
    got_v, got_i, got_rows = ptk.topk_gather_rows(xb, k, tb)
    torch.cuda.synchronize()
    assert (ptk.topk_lastdim.launches - counts[0],
            ptk.topk_lastdim.gather_launches - counts[1],
            ptk.topk_lastdim.wide_launches - counts[2],
            ptk.topk_gather_rows.launches - counts[3]) == (1, 1, int(k > 32),
                                                           1)
    assert torch.equal(got_i.cpu(), ids)
    assert torch.equal(got_v.cpu(), vals)
    got_rows = got_rows.cpu()
    assert torch.isnan(got_rows[~keep.view(-1)]).all()
    assert torch.equal(got_rows[keep.view(-1)], want_rows[keep.view(-1)])


def _attn_case(dev, n, tt, d, dtype, seed):
    g = _gen(seed)
    q, k, v, do = (torch.randn(n, tt, d, generator=g).to(dtype)
                   for _ in range(4))
    lens = torch.tensor([tt, tt - 9, tt // 2, 1, tt, 7]).repeat(
        (n + 5) // 6)[:n].clamp_min(1)
    bias = torch.where(torch.arange(tt)[None] < lens[:, None], 0.0, NEG)
    return [x.to(dev) for x in (q, k, v, bias, do)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tt,d", [(100, 16), (77, 32), (384, 64), (130, 128),
                                  (640, 64)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bwd_kernels_match_plain(dev, dtype, tol, tt, d, rate):
    """The forward with and without dropout, and the dq (with delta) and
    dkv kernels against the plain twins on the same inputs and seed:
    within ``tol`` of each output's largest entry (fp32 sums in another
    order; bf16: the same roundings of P~ and dS, two ulps at the top).
    T=640 is past the TPU kernels' resident limit (512)."""
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bwd_kernels_are_deterministic(dev, rate, dtype):
    """Two backward calls (bf16, and fp32 in split TF32) on the same
    inputs and seed give the same bits: every dQ, dK, dV element is
    written by one block, with no atomics."""
    q, k, v, bias, do = _attn_case(dev, 6, 384, 64, dtype, 5)
    seed = (7, 8) if rate else None
    out, lse = pfa.flash_attention_fwd(q, k, v, bias, 0.125, rate, seed)
    first = pfa.flash_attention_bwd(q, k, v, bias, out, do, lse, 0.125, rate,
                                    seed)
    second = pfa.flash_attention_bwd(q, k, v, bias, out, do, lse, 0.125,
                                     rate, seed)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("tt,d", [(384, 64), (130, 128), (77, 32)])
def test_flash_bf16_forward_is_the_twins_bit_for_bit(dev, rate, tt, d):
    """The bf16 forward rounds the normalised probabilities to bf16 before
    the value product, as the TPU kernel and the twin do, so most output
    elements equal the twin's bit for bit; only scores whose fp32 sums
    round apart (another summation order) differ, by an ulp."""
    q, k, v, bias, _ = _attn_case(dev, 6, tt, d, torch.bfloat16, tt)
    seed = (3, 9) if rate else None
    got, _ = pfa.flash_attention_fwd(q, k, v, bias, d ** -0.5, rate, seed)
    want, _ = pfa.flash_attention_plain(q, k, v, bias, d ** -0.5,
                                        dropout_rate=rate, dropout_seed=seed)
    torch.cuda.synchronize()
    assert (got == want).float().mean().item() >= 0.95


def test_flash_bf16_kernels_refuse_misaligned_operands(dev):
    """The bf16 kernels copy 16-byte chunks, and the TPU kernel takes any
    array: an operand that starts off a 16-byte boundary (a ``flat[1:]``
    view) is copied to an aligned tensor first, so the forward, dq and
    dkv equal the aligned operands' bit for bit, one launch each."""
    _misaligned_operands_are_copied(dev, torch.bfloat16)


def test_flash_fp32_kernels_refuse_misaligned_operands(dev):
    """The same for fp32 operands: the split-TF32 forward, dq and dkv copy
    16-byte chunks too, so a ``flat[1:]`` view (4 bytes off) is copied
    first and every output equals the aligned operands' bit for bit."""
    _misaligned_operands_are_copied(dev, torch.float32)


def _misaligned_operands_are_copied(dev, dtype):
    q, k, v, bias, do = _attn_case(dev, 2, 64, 32, dtype, 1)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16
        return view

    want, want_lse = pfa.flash_attention_fwd(q, k, v, bias, 0.2)
    want_dq, delta = pfa.flash_attention_bwd_dq(q, k, v, bias, want, do,
                                                want_lse, 0.2)
    want_dk, want_dv = pfa.flash_attention_bwd_dkv(q, k, v, bias, do,
                                                   want_lse, delta, 0.2)
    fns = (pfa.flash_attention_fwd, pfa.flash_attention_bwd_dq,
           pfa.flash_attention_bwd_dkv)
    before = [fn.launches for fn in fns]
    out, lse = fns[0](shifted(q), k, shifted(v), bias, 0.2)
    got_dq, _ = fns[1](q, shifted(k), v, bias, shifted(want), shifted(do),
                       want_lse, 0.2)
    dk, dv = fns[2](shifted(q), k, v, bias, shifted(do), want_lse, delta,
                    0.2)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert torch.equal(got_dq, want_dq)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,tt,d", [(6, 100, 16), (6, 77, 32), (6, 200, 64),
                                    (6, 130, 128), (128, 375, 64)])
def test_flash_fp32_backward_at_every_head_dim(dev, rate, n, tt, d):
    """The split-TF32 dq and dkv at every head dim the wrapper takes, T
    not a multiple of any tile, ragged keys with a head of one valid key,
    and at the muavic encoder's shape (N = 32x4, T = 375), with and
    without dropout: dq, dk and dv within 1e-4 of the twin's largest
    entry, delta within 1e-5 of its largest; the dk and dv rows of keys
    past a head's length exactly zero; two calls bit-identical."""
    q, k, v, bias, do = _attn_case(dev, n, tt, d, torch.float32, tt + d)
    seed = (19, 23) if rate else None
    sc = d ** -0.5
    out, lse = pfa.flash_attention_plain(q, k, v, bias, sc,
                                         dropout_rate=rate, dropout_seed=seed)
    dq, delta = pfa.flash_attention_bwd_dq(q, k, v, bias, out, do, lse, sc,
                                           rate, seed)
    dk, dv = pfa.flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta, sc,
                                         rate, seed)
    again = pfa.flash_attention_bwd(q, k, v, bias, out, do, lse, sc, rate,
                                    seed)
    wants = pfa.flash_attention_bwd_plain(q, k, v, bias, out, do, lse, sc,
                                          dropout_rate=rate,
                                          dropout_seed=seed)
    want_delta = pfa.attention_delta_plain(out, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    assert (delta - want_delta).abs().max() <= 1e-5 * want_delta.abs().max()
    for got, want in zip((dq, dk, dv), wants):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    masked = bias < 0
    assert (dk[masked] == 0).all() and (dv[masked] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("tt,d", [(100, 16), (77, 32), (200, 64), (130, 128)])
def test_flash_fp32_forward_at_every_head_dim(dev, rate, tt, d):
    """The split-TF32 forward at every head dim the wrapper takes, T not a
    multiple of the 64-key tile, ragged keys with a row of one valid key,
    with and without dropout: out within 1e-4 of its largest entry, lse
    within 1e-4 of the twin's; that row is its key's value row times
    the key's keep bit; two launches bit-identical."""
    q, k, v, bias, _ = _attn_case(dev, 6, tt, d, torch.float32, tt + d)
    seed = (13, 17) if rate else None
    out, lse = pfa.flash_attention_fwd(q, k, v, bias, d ** -0.5, rate, seed)
    again = pfa.flash_attention_fwd(q, k, v, bias, d ** -0.5, rate, seed)
    want, want_lse = pfa.flash_attention_plain(q, k, v, bias, d ** -0.5,
                                               dropout_rate=rate,
                                               dropout_seed=seed)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    top = want.abs().max()
    assert (out - want).abs().max() <= 1e-4 * top
    assert (lse - want_lse).abs().max() <= 1e-4
    keep = (pfa.dropout_keep_mask_plain(seed, 6, tt, rate, dev)[3, :, 0]
            if rate else torch.ones(tt, dtype=torch.bool, device=dev))
    _, inv_keep = pfa.dropout_threshold(rate) if rate else (0, 1.0)
    one = v[3, 0] * (keep.float() * inv_keep)[:, None]
    assert (out[3] - one).abs().max() <= 1e-4 * top


def test_flash_fp32_forward_single_key_rows(dev):
    """Rows whose one valid key lies in the first, a middle or the last,
    partial tile (T = 130): every earlier tile holds only -1e30 scores,
    which the first valid key's rescale wipes out, so out is that key's
    value row and lse its score."""
    n, tt, d = 4, 130, 64
    q, k, v, _, _ = _attn_case(dev, n, tt, d, torch.float32, 2)
    keys = torch.tensor([0, 63, 64, 129], device=dev)
    bias = torch.full((n, tt), NEG, device=dev)
    bias[torch.arange(n), keys] = 0.0
    out, lse = pfa.flash_attention_fwd(q, k, v, bias, 0.125)
    torch.cuda.synchronize()
    rows = torch.arange(n, device=dev)
    top = v.abs().max()
    assert (out - v[rows, keys][:, None]).abs().max() <= 1e-4 * top
    score = torch.einsum("ntd,nd->nt", q, k[rows, keys]) * 0.125
    assert (lse - score).abs().max() <= 1e-4 * score.abs().max()


def test_flash_fp32_forward_at_the_muavic_shape(dev):
    """The muavic encoder's self-attention (N = 32 x 4 heads, T = 375, D =
    64) with a ragged key bias a 4-head utterance: out and lse within
    1e-4 of the twin's."""
    b, heads, tt, d = 32, 4, 375, 64
    g = _gen(375)
    q, k, v = (torch.randn(b * heads, tt, d, generator=g).to(dev)
               for _ in range(3))
    lens = torch.full((b,), tt)
    lens[::5] = 200
    lens[1::7] = 1
    bias = torch.where(torch.arange(tt)[None] < lens[:, None], 0.0, NEG)
    bias = bias.repeat_interleave(heads, 0).to(dev)
    out, lse = pfa.flash_attention_fwd(q, k, v, bias, d ** -0.5)
    want, want_lse = pfa.flash_attention_plain(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()
    assert (lse - want_lse).abs().max() <= 1e-4


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


def _stem_case(dtype, n, c, h, w, ties, seed):
    g = _gen(seed)
    if ties:  # every value repeated over a 2x2 block: windows tie
        x = torch.randn(n, c, h // 2, w // 2, generator=g)
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    else:
        x = torch.randn(n, c, h, w, generator=g) * 2.0 + 0.3
    params = [1.0 + 0.1 * torch.randn(c, generator=g),
              0.1 * torch.randn(c, generator=g),
              0.25 + 0.05 * torch.randn(c, generator=g)]
    dout = torch.randn(n, c, h // 2, w // 2, generator=g)
    return x.to(dtype), params, dout.to(dtype)


@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,c,h,w", [(7, 16, 8, 12), (6, 64, 44, 44),
                                     (3, 5, 6, 2), (1, 64, 44, 44),
                                     (2, 16, 14, 10), (2, 64, 88, 88)])
def test_stem_kernels_match_plain(dev, dtype, tol, n, c, h, w, ties, layout):
    """The four bn_prelu_pool kernels through the autograd function on the
    card against the twins on the CPU, training: pooled output within tol
    x |max|, batch mean and var within 1e-5 relative, dx and the three
    parameter gradients within tol x |max| (bf16: x and dz are rounded
    where the twins round them; sums run in other orders); eval within
    tol x |max|. Each kernel launches once; a second run is bit-identical
    (no float atomics). The kernels read channels-last frames: an x in the
    contiguous (NCHW) layout is copied to it; the output comes back
    channels-last, dx in x's layout. The 3 x 5 x 6 x 2 case takes the
    scalar loads and threads' copies in bwd1; 44 x 44 (22 output rows) and
    14 x 10 (7) leave a partial strip of bwd1's 6 output rows; one frame
    has fewer strips than the card has SMs; 88 x 88 in fp32 fits bwd1's
    shared memory only at 2 output rows a strip and one buffer."""
    x, params, dout = _stem_case(dtype, n, c, h, w, ties, n * c + h)
    x = x.contiguous(memory_format=layout)
    res = {}
    counts = [psf.bn_prelu_pool_stats, psf.bn_prelu_pool_apply,
              psf.bn_prelu_pool_bwd1, psf.bn_prelu_pool_bwd2]
    before = [f.launches for f in counts]
    for where in ("cpu", dev, dev):
        xs = [x.to(where, copy=True).requires_grad_()] + [
            p.to(where, copy=True).requires_grad_() for p in params]
        out, mean, var = psf.bn_prelu_pool(*xs, train=True)
        out.backward(dout.to(where))
        res.setdefault(str(where), []).append(
            [y.detach().cpu() for y in (out, mean, var, *(v.grad for v in
                                                          xs))])
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counts, before)] == [2] * 4
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert xs[0].grad.is_contiguous(memory_format=layout)  # x's own layout
    want, (got, again) = res["cpu"][0], res[str(dev)]
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for name, g, r in zip(("out", "mean", "var", "dx", "dscale", "dbias",
                           "dalpha"), got, want):
        lim = (1e-5 if name in ("mean", "var") else tol) * r.float().abs(
        ).max()
        assert (g.float() - r.float()).abs().max() <= lim, name
    rm, rv = 0.1 * torch.randn(c, generator=_gen(1)), 1.0 + torch.rand(
        c, generator=_gen(2))
    evals = [psf.bn_prelu_pool(*(y.to(where) for y in (x, *params)),
                               train=False, running_mean=rm.to(where),
                               running_var=rv.to(where)).cpu()
             for where in ("cpu", dev)]
    assert (evals[1].float() - evals[0].float()).abs().max() <= (
        tol * evals[0].float().abs().max())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w", [(6, 64, 44, 44), (3, 5, 6, 2),
                                     (2, 64, 88, 88), (200, 64, 44, 44),
                                     (700, 5, 14, 6)])
def test_stem_bwd1_dz_is_the_twins(dev, dtype, n, c, h, w, ties):
    """bwd1's dz equals its twin's bit for bit on the same p: y, the pool's
    routing (first maximum), dy added in ascending k and dz round as the
    twin rounds them; the sums within 1e-4 of their largest entry. At 200
    and 700 frames the strips outnumber the blocks, so a block's next
    strip of a frame takes its first window row from the strip before."""
    x, (scale, bias, alpha), dout = _stem_case(dtype, n, c, h, w, ties, 11)
    x = x.contiguous(memory_format=torch.channels_last).to(dev)
    dout = dout.contiguous(memory_format=torch.channels_last).to(dev)
    scale, bias, alpha = (v.to(dev) for v in (scale, bias, alpha))
    mean, var = psf._batch_stats_plain(x.float())
    rstd = torch.rsqrt(var + 1e-5)
    p = psf._pack(mean, rstd, scale, bias, alpha)
    dz, red = psf.bn_prelu_pool_bwd1(x, p, dout)
    w_dz, dgamma, dbeta, dalpha = psf.bn_prelu_pool_bwd1_plain(
        x, scale, bias, alpha, mean, rstd, dout)
    torch.cuda.synchronize()
    assert torch.equal(dz, w_dz)
    want = torch.stack([dbeta, dgamma, dalpha])
    assert (red - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,offset", [
    (6, 64, 44, 44, 0), (200, 64, 44, 44, 0), (301, 64, 44, 44, 0),
    (7, 64, 8, 8, 0), (5, 16, 46, 46, 0), (2, 64, 88, 88, 0),
    (3, 5, 6, 2, 0), (700, 5, 14, 6, 0), (9, 64, 44, 44, 1)])
def test_stem_apply_is_the_twins_bit_for_bit(dev, dtype, n, c, h, w, offset):
    """The apply pass equals its twin given the same p bit for bit: y and
    the window maxima are exact, rounded once. Strips of the 44 x 44 frame
    end part-way (22 output rows), 8 x 8 frames are one strip, 46 x 46
    leaves a 5-row strip; at 200 and 301 frames the strips outnumber the
    blocks (a run's strips carry their first input row's maxima, runs end
    mid-frame); 88 x 88 fits fewer rows a strip; 5 channels (rows not
    16-byte multiples) and a tensor starting one element off a 16-byte
    boundary take the threads' copies."""
    x, (scale, bias, alpha), _ = _stem_case(dtype, n, c, h, w, False, 17)
    flat = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
    x = flat[offset:].view(n, h, w, c).copy_(
        x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    scale, bias, alpha = (v.to(dev) for v in (scale, bias, alpha))
    mean, var = psf._batch_stats_plain(x.float())
    p = psf._pack(mean, torch.rsqrt(var + 1e-5), scale, bias, alpha)
    before = psf.bn_prelu_pool_apply.launches
    out = psf.bn_prelu_pool_apply(x, p)
    want = psf.bn_prelu_pool_plain(x, scale, bias, alpha, train=False,
                                   running_mean=mean, running_var=var)
    torch.cuda.synchronize()
    assert psf.bn_prelu_pool_apply.launches == before + 1
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, want)


def _layer(c, heads, f, seed):
    from avsr_tpu_torch.models.decoder import DecoderLayer

    torch.manual_seed(seed)
    layer = DecoderLayer(c, heads, f)
    with torch.no_grad():
        for norm in (layer.norm1, layer.norm2, layer.norm3):
            norm.weight.normal_(1.0, 0.1)
            norm.bias.normal_(0.0, 0.1)
    return layer


@pytest.mark.parametrize("pos", [0, 7, 15, 19])
@pytest.mark.parametrize("pdtype,cdtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,k,c,heads,f", [(3, 3, 128, 2, 256),
                                           (8, 3, 1024, 16, 3072),
                                           (32, 3, 1024, 16, 3072),
                                           (8, 3, 768, 12, 3072),
                                           (2, 5, 32, 4, 64),
                                           (13, 3, 64, 1, 128)])
def test_decoder_layer_kernel_matches_plain(dev, pos, pdtype, cdtype, tol, b,
                                            k, c, heads, f):
    """decoder_layer_step (one cooperative launch) against its twin on the
    same inputs, S=16 rows of cache, 11 source rows with the last 3 of
    utterance 1 padded, a random ancestry with the beam's contract (rows
    past pos masked on every lane): x_out and the written row within tol x
    |max|; the rest of the cache untouched; at pos >= S row S-1 is the one
    written. One launch per call at every batch, 96 lanes (B=32, K=3)
    and 39 included, the flagship decoder's widths and the conformer's
    (C=768, 12 heads, F=4C); two calls give bit-equal outputs; the
    block's shared memory, as the kernel reports it, within 227 KB."""
    s, s_enc = 16, 11
    n = b * k
    g = _gen(pos + c)
    packed = pdl.pack_layer_params(_layer(c, heads, f, pos), pdtype)
    x = torch.randn(n, c, generator=g).to(pdtype)
    kv = torch.randn(n, s, 2 * c, generator=g).to(cdtype)
    src_k, src_v = (torch.randn(b, s_enc, c, generator=g).to(cdtype)
                    for _ in range(2))
    mem_bias = torch.zeros(b, s_enc)
    mem_bias[1 % b, -3:] = NEG
    anc = torch.randint(0, k, (s, b, k), generator=g)
    anc[min(pos, s - 1)] = torch.arange(k)
    valid = (torch.arange(s) <= pos)[:, None, None, None] & (
        anc[..., None] == torch.arange(k))
    lane_bias = torch.where(valid.permute(1, 2, 0, 3), 0.0, NEG).contiguous()
    args = (x, kv, src_k, src_v, mem_bias, lane_bias)
    want_x, want_kv = pdl.decoder_layer_step(pos, *(a.clone() for a in args),
                                             packed, k, heads)
    before = pdl.decoder_layer_step.launches
    dargs = [a.to(dev) for a in args]
    dpacked = pdl.PackedLayer(*(p.to(dev) for p in packed))
    got_x, got_kv = pdl.decoder_layer_step(pos, *dargs, dpacked, k, heads)
    torch.cuda.synchronize()
    assert pdl.decoder_layer_step.launches == before + 1
    assert got_kv is dargs[1]
    # the kernel's own layout: a block's shared memory within 227 KB
    plan, smem = pdl.card_plan(n, k, heads, c, f, s, s_enc, pdtype, cdtype,
                               torch.cuda.current_device())
    assert 0 < smem <= 227 * 1024 and plan.grid >= 1
    # a scratch made once (as the decoder's cache keeps it) gives the same
    again = [a.to(dev) for a in args]
    scratch = pdl.layer_scratch(n, c, f, dev)
    for _ in range(2):
        again_x, _ = pdl.decoder_layer_step(pos, *[a.clone() for a in again],
                                            dpacked, k, heads,
                                            scratch=scratch)
        assert torch.equal(again_x, got_x)
    row = min(pos, s - 1)
    rest = [i for i in range(s) if i != row]
    assert torch.equal(got_kv[:, rest].cpu(), kv[:, rest])
    for name, a, r in (("x_out", got_x, want_x),
                       ("row", got_kv[:, row], want_kv[:, row])):
        r = r.float()
        assert (a.float().cpu() - r).abs().max() <= tol * r.abs().max(), name


@pytest.mark.parametrize("lanes", [8, 9, 10, 22, 32])
@pytest.mark.parametrize("pos", [0, 100, 191, 250])
@pytest.mark.parametrize("pdtype,cdtype,tol", [
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.float32, 2e-5)])
def test_decoder_layer_kernel_wide_beams(dev, lanes, pos, pdtype, cdtype,
                                         tol):
    """decoder_layer_step above 8 lanes (ROADMAP C30) at the model's widths
    (C=1024, H=16, F=3072) over a 192-row cache and 40 source rows, B=2:
    8, 9 and 10 lanes in one pass; 22 and 32 from pos 100 on in two passes
    over tiles of the rows (their scores do not fit a block): x_out and the
    written row within tol x |max| of the twin's, the rest of the cache
    untouched, one launch, two calls bit-equal."""
    b, c, heads, f, s, s_enc = 2, 1024, 16, 3072, 192, 40
    n = b * lanes
    g = _gen(pos + lanes)
    packed = pdl.pack_layer_params(_layer(c, heads, f, pos), pdtype)
    x = torch.randn(n, c, generator=g).to(pdtype)
    kv = torch.randn(n, s, 2 * c, generator=g).to(cdtype)
    src_k, src_v = (torch.randn(b, s_enc, c, generator=g).to(cdtype)
                    for _ in range(2))
    mem_bias = torch.zeros(b, s_enc)
    mem_bias[1, -3:] = NEG
    anc = torch.randint(0, lanes, (s, b, lanes), generator=g)
    anc[min(pos, s - 1)] = torch.arange(lanes)
    valid = (torch.arange(s) <= pos)[:, None, None, None] & (
        anc[..., None] == torch.arange(lanes))
    lane_bias = torch.where(valid.permute(1, 2, 0, 3), 0.0, NEG).contiguous()
    args = (x, kv, src_k, src_v, mem_bias, lane_bias)
    want_x, want_kv = pdl.decoder_layer_step(pos, *(a.clone() for a in args),
                                             packed, lanes, heads)
    dpacked = pdl.PackedLayer(*(p.to(dev) for p in packed))
    before = pdl.decoder_layer_step.launches
    outs = []
    for _ in range(2):
        dargs = [a.to(dev) for a in args]
        got_x, got_kv = pdl.decoder_layer_step(pos, *dargs, dpacked, lanes,
                                               heads)
        outs.append((got_x, got_kv))
    torch.cuda.synchronize()
    assert pdl.decoder_layer_step.launches == before + 2
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    row = min(pos, s - 1)
    rest = [i for i in range(s) if i != row]
    assert torch.equal(got_kv[:, rest].cpu(), kv[:, rest])
    for name, a, r in (("x_out", got_x, want_x),
                       ("row", got_kv[:, row], want_kv[:, row])):
        r = r.float()
        assert (a.float().cpu() - r).abs().max() <= tol * r.abs().max(), name


def test_decoder_layer_kernel_refuses_beyond_its_lanes(dev):
    """More than MAX_LANES (32) lanes an utterance: ValueError naming the
    limit, before anything is launched."""
    lanes, c, heads, f = pdl.MAX_LANES + 1, 64, 1, 128
    packed = pdl.PackedLayer(*(p.to(dev) for p in pdl.pack_layer_params(
        _layer(c, heads, f, 0), torch.float32)))
    kv = torch.zeros(lanes, 8, 2 * c, device=dev)
    src = torch.zeros(1, 5, c, device=dev)
    with pytest.raises(ValueError, match=str(pdl.MAX_LANES)):
        pdl.decoder_layer_step(0, torch.zeros(lanes, c, device=dev), kv, src,
                               src, torch.zeros(1, 5, device=dev),
                               torch.zeros(1, lanes, 8, lanes, device=dev),
                               packed, lanes, heads)


# ---------------------------------------------------------------- frontends


def _frontend_case(name):
    """(network, inputs) at small sizes, torch's seeded initialisation."""
    from avsr_tpu_torch.frontends import asd as pasd
    from avsr_tpu_torch.frontends import fan as pfan
    from avsr_tpu_torch.frontends import retinaface as prf
    from avsr_tpu_torch.frontends import s3fd as ps3

    torch.manual_seed(0)
    g = _gen(1)
    if name == "asd":
        return pasd.ASDModel(), (torch.randn(2, 40, 13, generator=g),
                                 torch.rand(2, 10, 48, 48, generator=g) * 255)
    net = {"retinaface_mobilenet": lambda: prf.RetinaFaceNet(
               "mobilenet0.25", 64),
           "retinaface_resnet50": lambda: prf.RetinaFaceNet("resnet50", 256),
           "s3fd": ps3.S3FDNet, "fan": lambda: pfan.FAN(1)}[name]()
    size = (64, 64) if name == "fan" else (100, 140)
    return net, (torch.randn((2, 3) + size, generator=g),)


@pytest.mark.parametrize("name", ["retinaface_mobilenet",
                                  "retinaface_resnet50", "s3fd", "fan",
                                  "asd"])
def test_frontend_network_cuda_matches_cpu(dev, name):
    """Each frontend network in eval mode on the card against the CPU,
    fp32 (TF32 off): within 1e-4 of the largest output."""
    net, inputs = _frontend_case(name)
    net.eval()
    with torch.no_grad():
        want = net(*inputs)
        got = net.to(dev)(*(x.to(dev) for x in inputs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        if torch.is_tensor(w):
            torch.testing.assert_close(g.cpu(), w, rtol=0,
                                       atol=1e-4 * w.abs().max().item())
        else:
            assert g == w


def test_asd_train_step_cuda_matches_cpu(dev):
    """One ``ASDTrainer`` step on the card against the CPU from the same
    weights: loss within 1e-5 relative, gradient norm within 1e-4, and
    the BN running statistics within 1e-5."""
    import numpy as np

    from avsr_tpu_torch.frontends import asd_trainer as pasdt

    rng = np.random.RandomState(0)
    batch = (rng.randn(2, 40, 13).astype(np.float32),
             (rng.rand(2, 10, 48, 48) * 255).astype(np.float32),
             rng.randint(0, 2, (2, 10)))
    out = []
    for device in ("cpu", dev):
        trainer = pasdt.ASDTrainer(device=device)
        loss = trainer.train_step(*batch, 1.3, 1e-3)[0]
        norm = torch.sqrt(sum((p.grad.double() ** 2).sum()
                              for p in trainer.model.parameters())).item()
        stats = {k: v.cpu() for k, v in trainer.model.state_dict().items()
                 if "running" in k}
        out.append((loss, norm, stats))
    (lc, nc, sc), (lg, ng, sg) = out
    assert lg == pytest.approx(lc, rel=1e-5)
    assert ng == pytest.approx(nc, rel=1e-4)
    for k in sc:
        torch.testing.assert_close(sg[k], sc[k], rtol=1e-5, atol=1e-5)


# ------------------------------------------------ the beam's device loop


def _captured(fn):
    """fn() run once on a side stream (the kernel built, its shared memory
    raised), then captured in a CUDA graph: (graph, its outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _decode_inputs(pos, b=2, k=3, s=192, heads=16, dtype=torch.bfloat16):
    from torch_port_common import decode_case

    q, kv, row, bias = (torch.from_numpy(x).contiguous() for x in decode_case(
        pos, b=b, k=k, s_max=s, heads=heads, dh=64, pos=pos, q_scale=0.125))
    return q.to(dtype), kv.to(dtype), row.to(dtype), bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_reads_the_step_in_a_graph(dev, dtype):
    """B2 captured once at step 0, then replayed with its step (one int32 on
    the card), its cache and its bias set for pos 0, 191 and 250 (pos >= S
    writes row S-1): each replay's cache equal to the twin's and its output
    within ``output_bound``, the launch plan the same at every step."""
    heads = 16
    st = [x.to(dev) for x in _decode_inputs(0, dtype=dtype)]
    step = torch.zeros(1, dtype=torch.int32, device=dev)
    graph, (out, kv) = _captured(lambda: pda.decode_attention(
        step, st[0], st[1], st[3], 3, heads, st[2]))
    for pos in (0, 191, 250):
        q, kv0, row, bias = _decode_inputs(pos, dtype=dtype)
        for d, x in zip(st, (q, kv0, row, bias)):
            d.copy_(x)
        step.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        want, want_kv = pda.decode_attention_plain(pos, q, kv0.clone(), bias,
                                                   3, heads, row)
        bnd = pda.output_bound(pos, q, kv0, bias, 3, heads, row)
        assert torch.equal(kv.cpu(), want_kv), pos
        assert bool(((out.float().cpu() - want.float()).abs() <= bnd).all())


def test_bookkeeping_kernel_reads_the_step_in_a_graph(dev):
    """B8 (narrow and wide) captured once, replayed at steps 4, 9 and 19 of
    ``beam_step_case`` states: every output equal to the twin's."""
    kw = dict(w_dec=0.9, w_ctc=0.1, eos=49, neg=NEG, d_end=-10.0, m_end=3)
    for k, sp in ((3, 4), (10, 15)):
        case = beam_step_case(0, 4, k=k, sp=sp)
        st = {n: torch.from_numpy(v).to(dev) for n, v in case.items()}
        step = torch.zeros(1, dtype=torch.int32, device=dev)
        graph, out = _captured(lambda: pbu.beam_update(step, *st.values(),
                                                       **kw))
        for i in (4, 9, 19):
            case = beam_step_case(i, i, k=k, sp=sp)
            for n, v in case.items():
                st[n].copy_(torch.from_numpy(v))
            step.fill_(i)
            graph.replay()
            torch.cuda.synchronize()
            want = pbu.beam_update_plain(
                i, *(torch.from_numpy(v) for v in case.values()), **kw)
            for n, w in want.items():
                assert torch.equal(out[n].cpu(), w), (k, i, n)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
def test_layer_kernel_reads_the_step_in_a_graph(dev, dtype, tol):
    """B9 (a cooperative launch) captured once, replayed at pos 0, 7 and 20
    over a 16-row cache (pos >= S: every stored row plus the fresh one, row
    S-1 written), its grid-sync counters zero again after each replay: x_out
    and the written row within tol of their largest entry."""
    b, k, c, heads, f, s, s_enc = 2, 3, 256, 4, 512, 16, 11
    packed = pdl.PackedLayer(*(p.to(dev) for p in pdl.pack_layer_params(
        _layer(c, heads, f, 0), dtype)))
    scratch = pdl.layer_scratch(b * k, c, f, dev)

    def inputs(pos):
        g = _gen(pos)
        x = torch.randn(b * k, c, generator=g).to(dtype)
        kv = torch.randn(b * k, s, 2 * c, generator=g).to(dtype)
        src = torch.randn(b, s_enc, c, generator=g).to(dtype)
        anc = torch.randint(0, k, (s, b, k), generator=g)
        anc[min(pos, s - 1)] = torch.arange(k)
        valid = (torch.arange(s) <= pos)[:, None, None, None] & (
            anc[..., None] == torch.arange(k))
        bias = torch.where(valid.permute(1, 2, 0, 3), 0.0, NEG).contiguous()
        return x, kv, src, torch.zeros(b, s_enc), bias

    st = [t.to(dev) for t in inputs(0)]
    step = torch.zeros(1, dtype=torch.int32, device=dev)
    graph, (out, kv) = _captured(lambda: pdl.decoder_layer_step(
        step, st[0], st[1], st[2], st[2], st[3], st[4], packed, k, heads,
        scratch=scratch))
    for pos in (0, 7, 20):
        host = inputs(pos)
        for d, x in zip(st, host):
            d.copy_(x)
        step.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        assert not scratch.counters.any()
        x, kv0, src, mem_bias, bias = host
        want, want_kv = pdl.decoder_layer_step_plain(
            pos, x, kv0.clone(), src, src, mem_bias, bias,
            pdl.PackedLayer(*(p.cpu() for p in packed)), k, heads)
        row = min(pos, s - 1)
        for got, w in ((out, want), (kv[:, row], want_kv[:, row])):
            err = (got.float().cpu() - w.float()).abs().max()
            assert err <= tol * w.float().abs().max(), (pos, err)


@pytest.mark.parametrize("fused", [False, True])
def test_device_loop_matches_host_loop(dev, fused):
    """The tiny flagship model's beam on the card through its device loop
    (CUDA graphs) and its host loop: the same tokens, lengths and scores,
    ceil(steps / k) host reads, and the same launches of every kernel (the
    replays add the launches their capture made); a second batch of the
    shape replays without a capture."""
    from torch_port_common import tiny_port_cfg

    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.decode import beam as pbeam
    from avsr_tpu_torch.decode import device_loop
    from avsr_tpu_torch.decode.recognizer import Recognizer
    from avsr_tpu_torch.models.e2e import AVSRModel

    cfg = tiny_port_cfg()
    model = AVSRModel(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    rec = Recognizer(model=model, cfg=cfg, device="cuda", beam_size=3,
                     t_buckets=(24,), max_decode_tokens=16,
                     fused_bookkeeping=fused)
    bcfg = rec.beam_config()
    g = _gen(1)
    feats = torch.randn(3, 24, 32, generator=g).to(dev)
    ctc = torch.log_softmax(torch.randn(3, 24, cfg.odim, generator=g),
                            -1).to(dev)
    lens = torch.tensor([24, 13, 17], device=dev)
    runs = {}
    for device_loop_on in (True, False, True):
        before = device_loop.launch_counts()
        out = pbeam.beam_search_batched(
            bcfg, model.decoder_step, model.decoder_init, feats, ctc, lens,
            device_loop=device_loop_on, stop_every=5)
        torch.cuda.synchronize()
        after = device_loop.launch_counts()
        stats = dict(pbeam.beam_search_batched.last_run)
        launched = {key: n - before[key] for key, n in after.items()}
        runs.setdefault(device_loop_on, []).append((out, stats, launched))
    (out, stats, launched), (again, stats2, _) = runs[True]
    host_out, host_stats, host_launched = runs[False][0]
    for a, b_, c_ in zip(out, host_out, again):
        assert torch.equal(a, b_) and torch.equal(a, c_)
    assert stats["steps"] == host_stats["steps"] == 24
    assert stats["reads"] == 5 and host_stats["reads"] == 24
    assert stats["captures"] >= 1 and stats2["captures"] == 0
    assert stats2["replays"] == stats["replays"] >= 1
    assert launched == host_launched


def _ctc_case(b, tt, v, l, seed):
    """Logits (B, T, V) of std 2, labels (B, L) with runs of repeats,
    padded with -1 and with ids past V; sample 1 shorter, sample 2
    infeasible (T = L - 1), the last with no labels."""
    g = _gen(seed)
    logits = torch.randn(b, tt, v, generator=g) * 2
    labels = torch.randint(1, v, (b, l), generator=g)
    if l > 4:
        labels[:, 2:5] = labels[:, 2:3]
    llen = torch.full((b,), tt)
    lablen = torch.full((b,), l)
    llen[1], lablen[1] = tt - tt // 3, max(0, l - 3)
    llen[2] = max(1, l - 1)
    lablen[-1] = 0
    pad = torch.arange(l)[None, :] >= lablen[:, None]
    labels = torch.where(pad, torch.where(torch.arange(b)[:, None] % 2 == 0,
                                          -1, v + 7), labels)
    return logits, llen, labels, lablen


@pytest.mark.parametrize("b,tt,v,l,blank", [(6, 384, 5049, 48, 0),
                                            (4, 300, 37, 130, 0),
                                            (4, 33, 9, 5, 4)])
def test_ctc_loss_kernel_matches_plain(dev, b, tt, v, l, blank):
    """The kernels given the CPU twins' log-probs: the per-sample NLL
    within 1e-6 relative, alpha, beta and the logits' gradient within 1e-6
    of their largest entries (both run the recursions in float64; the fp32
    exps differ by an ulp or two), keep equal. Then the loss from the
    logits through autograd against the twin on the card (the same
    log-softmax): the same limits, the infeasible sample's NLL and
    gradient exactly 0, frames past a length exactly 0, two calls
    bit-equal. L=130 holds 261 states, three chunks of a block's
    threads."""
    logits, llen, labels, lablen = _ctc_case(b, tt, v, l, tt)
    w = torch.linspace(0.5, 1.5, b)
    logp = torch.log_softmax(logits, -1)
    want = pcl.ctc_fwd_plain(logp, labels, llen, lablen, blank)
    want_g = pcl.ctc_bwd_plain(logp, *want[2:], labels, llen, lablen,
                               want[1], w, blank)
    d = [x.to(dev) for x in (logp, labels, llen, lablen)]
    got = pcl.ctc_loss_fwd(*d, blank)
    got_g = pcl.ctc_loss_bwd(d[0], *got[2:], *d[1:], got[1], w.to(dev),
                             blank)
    torch.cuda.synchronize()
    got, got_g = [x.cpu() for x in got], got_g.cpu()
    live = torch.arange(tt)[None, :, None] < llen[:, None, None]
    states = torch.arange(2 * l + 1)[None, None, :] < (2 * lablen + 1)[
        :, None, None]
    assert torch.equal(got[1], want[1])
    assert ((got[0] - want[0]).abs() <= 1e-6 * want[0].abs()).all()
    for a, b_ in zip(got[2:], want[2:]):
        m = live & states & torch.isfinite(b_)
        assert torch.equal(torch.isfinite(a) & live & states, m)
        assert (a - b_)[m].abs().max() <= 1e-6 * b_[m].abs().max()
    assert (got_g - want_g).abs().max() <= 1e-6 * want_g.abs().max()

    x = logits.to(dev).requires_grad_()
    want = pcl.ctc_loss_plain(x, *(y.to(dev) for y in (llen, labels,
                                                        lablen)), blank)
    (want_g,) = torch.autograd.grad((want * w.to(dev)).sum(), x)
    runs = []
    for _ in range(2):
        got = pcl.ctc_loss(x, *(y.to(dev) for y in (llen, labels, lablen)),
                           blank)
        (got_g,) = torch.autograd.grad((got * w.to(dev)).sum(), x)
        torch.cuda.synchronize()
        runs.append((got.cpu(), got_g.cpu()))
    (got, got_g), (again, again_g) = runs
    want, want_g = want.detach().cpu(), want_g.cpu()
    assert torch.equal(got, again) and torch.equal(got_g, again_g)
    assert got[2] == 0 and want[2] == 0 and not got_g[2].any()
    assert (got[[0, 1, -1]] > 0).all()
    assert ((got - want).abs() <= 1e-6 * want.abs()).all()
    assert (got_g - want_g).abs().max() <= 1e-6 * want_g.abs().max()
    assert not got_g[1, llen[1]:].any()
