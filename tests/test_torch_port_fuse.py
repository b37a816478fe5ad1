"""The port's last two kernels' twins against the JAX package, on the CPU.

- ``bn_prelu_pool`` (the fused stem tail, ops/kernels/stem_fuse.py) against
  ``avsr_tpu.ops.pallas.stem_fuse.bn_prelu_pool`` in interpret mode:
  forward in training and eval, the four gradients, first-maximum tie
  routing, bf16 parameter-gradient dtypes. The port's layout is (N, C, H, W),
  JAX's (N, H, W, C).
- ``decoder_layer_step`` (ops/kernels/decoder_layer.py) against
  ``avsr_tpu.ops.pallas.decoder_layer.decoder_layer_step`` in interpret mode,
  at pos 0, mid-cache, S-1 and past the cap (S+3).
- The tiny config's Recognizer with ``decode_fused_layer`` on both sides.
- A coverage guard: every ``pl.pallas_call`` of the JAX package has a port
  wrapper that counts its launches and a CUDA source.

On CPU tensors the wrappers run their plain twins; the CUDA kernels are held
against the same twins on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.ops.kernels import decoder_layer as pdl  # noqa: E402
from avsr_tpu_torch.ops.kernels import stem_fuse as psf  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    jax_tiny_model,
    port_cfg,
    port_model,
    setup_torch,
    t,
    tiny_cfg,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
NEG = -1.0e30


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


# ---------------------------------------------------------------- stem


def _stem_data(seed=0, n=6, h=8, w=12, c=16, ties=False):
    """x (N, H, W, C) and the per-channel scale, bias, alpha, as numpy;
    ``ties`` repeats every value over a 2x2 block, so windows hold equal
    maxima."""
    r = np.random.RandomState(seed)
    if ties:
        base = r.randn(n, h // 2, w // 2, c).astype(np.float32)
        x = np.repeat(np.repeat(base, 2, axis=1), 2, axis=2)
    else:
        x = r.randn(n, h, w, c).astype(np.float32)
    return (x, (1.0 + 0.1 * r.randn(c)).astype(np.float32),
            (0.1 * r.randn(c)).astype(np.float32),
            (0.25 + 0.05 * r.randn(c)).astype(np.float32))


def _nchw(x):
    return t(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return np.asarray(x.float().numpy()).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), ("bf16", 0.05)])
def test_stem_forward_matches_jax(train, dtype, atol):
    """Pooled output within 2e-5 in fp32 and 0.05 in bf16 (the kernel's fp32
    z rounded once; one bf16 ulp near |y| ~ 4); batch mean and var within
    1e-5."""
    from avsr_tpu.ops.pallas import stem_fuse

    x, scale, bias, alpha = _stem_data(seed=1)
    r = np.random.RandomState(2)
    rm = (0.1 * r.randn(x.shape[-1])).astype(np.float32)
    rv = (1.0 + 0.2 * r.rand(x.shape[-1])).astype(np.float32)
    jx, px = jnp.asarray(x), _nchw(x)
    if dtype == "bf16":
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    kw = {} if train else dict(running_mean=rm, running_var=rv)
    want = stem_fuse.bn_prelu_pool(
        jx, *(jnp.asarray(v) for v in (scale, bias, alpha)), train=train,
        interpret=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = psf.bn_prelu_pool(px, t(scale), t(bias), t(alpha), train=train,
                            **{k: t(v) for k, v in kw.items()})
    if train:
        (want, wm, wv), (got, gm, gv) = want, got
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-5)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)
    assert got.dtype == px.dtype and got.shape == (6, 16, 4, 6)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _stem_grads_jax(x, params, w, interpret=True):
    from avsr_tpu.ops.pallas import stem_fuse

    def loss(x, s, b, a):
        out, _, _ = stem_fuse.bn_prelu_pool(x, s, b, a, train=True,
                                            interpret=interpret)
        return jnp.sum(out.astype(jnp.float32) * w)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(x, *params)


def _stem_grads_port(x, params, w):
    xs = [x.clone().requires_grad_()] + [
        p.clone().requires_grad_() for p in params]
    out, mean, var = psf.bn_prelu_pool(*xs, train=True)
    assert not mean.requires_grad and not var.requires_grad
    (out.float() * w).sum().backward()
    return [v.grad for v in xs]


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (7, True)])
def test_stem_grads_match_jax(seed, ties):
    """dx, dscale, dbias, dalpha against jax.grad through the Pallas
    backward: atol 5e-4, rtol 1e-4 (sums over N H W in other orders); with
    2x2 duplicated values dx within 5e-5, which holds only if both send
    each window's cotangent to its first maximum in row-major order."""
    x, scale, bias, alpha = _stem_data(seed=seed, ties=ties)
    w = np.random.RandomState(9).randn(6, 4, 6, 16).astype(np.float32)
    want = _stem_grads_jax(jnp.asarray(x),
                           [jnp.asarray(v) for v in (scale, bias, alpha)],
                           jnp.asarray(w))
    got = _stem_grads_port(_nchw(x), [t(v) for v in (scale, bias, alpha)],
                           _nchw(w))
    for name, g, ref in zip(("dx", "dscale", "dbias", "dalpha"), got, want):
        g = _nhwc(g) if name == "dx" else g.numpy()
        atol = 5e-5 if (ties and name == "dx") else 5e-4
        np.testing.assert_allclose(g, np.asarray(ref), atol=atol, rtol=1e-4,
                                   err_msg=name)


def test_stem_tie_routing_first_maximum():
    """Every window of a constant plane ties: the whole cotangent of each
    window lands on its first (top-left) valid position."""
    y = torch.zeros(1, 1, 4, 4)
    dout = torch.arange(1.0, 5.0).view(1, 1, 2, 2)
    dy = psf.pool_bwd_plain(y, dout)
    want = torch.zeros(4, 4)
    want[0, 0], want[0, 1], want[1, 0], want[1, 1] = 1.0, 2.0, 3.0, 4.0
    assert torch.equal(dy[0, 0], want)


def test_stem_bf16_param_grads_keep_their_dtypes():
    """The trainer casts the fp32 masters to bf16: the gradients come back
    in bf16, within 2e-2 of JAX's (whose custom VJP returns the primal
    dtypes too)."""
    x, scale, bias, alpha = _stem_data(seed=3)
    w = np.random.RandomState(4).randn(6, 4, 6, 16).astype(np.float32)
    want = _stem_grads_jax(
        jnp.asarray(x),
        [jnp.asarray(v).astype(jnp.bfloat16) for v in (scale, bias, alpha)],
        jnp.asarray(w))
    got = _stem_grads_port(
        _nchw(x), [t(v).to(torch.bfloat16) for v in (scale, bias, alpha)],
        _nchw(w))
    assert got[0].dtype == torch.float32
    for name, g, ref in zip(("dscale", "dbias", "dalpha"), got[1:],
                            want[1:]):
        assert g.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(ref, np.float32), atol=2e-2,
                                   rtol=2e-2, err_msg=name)


def test_resnet_switches_select_the_fused_tail(monkeypatch):
    """AVSR_FUSED_STEM / AVSR_FUSED_STEM_EVAL route the port's ResEncoder
    through bn_prelu_pool: in fp32 the encoder's output equals the unfused
    stem tail's to rounding, 2e-5 of its largest entry (the two fold BN
    in another order, an ulp apart, and the train-mode trunk over 6 frames
    amplifies that, C16), the running averages move alike, and the state
    dict's keys are unchanged."""
    from avsr_tpu_torch.models.resnet import ResEncoder

    torch.manual_seed(0)
    video = torch.randn(2, 3, 16, 16, 1)
    calls = []
    real = psf.bn_prelu_pool

    def counted(*a, **kw):
        calls.append(kw["train"])
        return real(*a, **kw)

    monkeypatch.setattr("avsr_tpu_torch.models.resnet.bn_prelu_pool", counted)
    base = ResEncoder()
    for train, switch in ((True, "AVSR_FUSED_STEM"),
                          (False, "AVSR_FUSED_STEM_EVAL")):
        plain, fused = ResEncoder(), ResEncoder()
        plain.load_state_dict(base.state_dict())
        fused.load_state_dict(base.state_dict())
        monkeypatch.delenv(switch, raising=False)
        want = plain(video, train)
        monkeypatch.setenv(switch, "1")
        got = fused(video, train)
        monkeypatch.delenv(switch)
        lim = 2e-5 * want.abs().max().item()
        torch.testing.assert_close(got, want, atol=lim, rtol=0)
        for k, v in plain.state_dict().items():
            torch.testing.assert_close(fused.state_dict()[k], v, atol=1e-6,
                                       rtol=0)
    assert calls == [True, False]
    assert set(fused.state_dict()) == set(base.state_dict())


# ---------------------------------------------------------- decoder layer

B, K, S, S_ENC, C, HEADS, F = 3, 3, 16, 11, 32, 4, 64


def _layer_tree(rng):
    """A JAX DecoderLayer parameter tree (kernels (in, out)) of random
    weights; LN scales around 1."""
    def dense(i, o):
        return {"kernel": (rng.randn(i, o) / np.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.randn(o)).astype(np.float32)}

    def norm():
        return {"scale": (1.0 + 0.1 * rng.randn(C)).astype(np.float32),
                "bias": (0.1 * rng.randn(C)).astype(np.float32)}

    def mha():
        return {n: dense(C, C) for n in ("linear_q", "linear_k", "linear_v",
                                         "linear_out")}

    return {"self_attn": mha(), "src_attn": mha(), "w_1": dense(C, F),
            "w_2": dense(F, C), "norm1": norm(), "norm2": norm(),
            "norm3": norm()}


def _port_layer(tree):
    """The port's DecoderLayer holding the tree's weights."""
    from avsr_tpu_torch.models.decoder import DecoderLayer

    layer = DecoderLayer(C, HEADS, F)
    with torch.no_grad():
        for name, mod in layer.named_modules():
            node = tree
            for part in name.replace("feed_forward.", "").split("."):
                node = node.get(part) if part else node
            if isinstance(mod, torch.nn.Linear):
                mod.weight.copy_(t(node["kernel"].T))
                mod.bias.copy_(t(node["bias"]))
            elif isinstance(mod, torch.nn.LayerNorm):
                mod.weight.copy_(t(node["scale"]))
                mod.bias.copy_(t(node["bias"]))
    return layer


def _layer_case(pos, seed):
    """(x, cache, src_k, src_v, mem_bias, lane_bias) as numpy: a random
    ancestry in which every row s > pos is masked on every lane (the
    beam's contract) and this step's row is each lane's own; utterance 1
    has its last 3 source rows padded."""
    rng = np.random.RandomState(seed)
    n = B * K
    x = rng.randn(n, C).astype(np.float32)
    kv = rng.randn(n, S, 2 * C).astype(np.float32)
    src_k, src_v = (rng.randn(B, S_ENC, C).astype(np.float32)
                    for _ in range(2))
    mem_bias = np.zeros((B, S_ENC), np.float32)
    mem_bias[1, -3:] = NEG
    anc = rng.randint(0, K, size=(S, B, K))
    anc[min(pos, S - 1)] = np.arange(K)
    valid = (np.arange(S) <= pos)[:, None, None, None] & (
        anc[..., None] == np.arange(K))
    lane_bias = np.where(valid.transpose(1, 2, 0, 3), 0.0, NEG)
    return x, kv, src_k, src_v, mem_bias, lane_bias.astype(np.float32)


@pytest.mark.parametrize("pos", [0, 7, S - 1, S + 3])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_decoder_layer_matches_jax(pos, dtype, tol):
    """x_out and the whole K|V cache (the row written at min(pos, S-1))
    against the Pallas kernel in interpret mode, B=3 (odd), K=3, a padded
    source row, within tol x |max| (fp32 2e-5: sums in another order;
    bf16 2e-2: a bf16 ulp of the rounded operands). At pos = S+3 both
    attend all S stored rows, the stale row S-1 included, plus the fresh
    row, then write row S-1."""
    from avsr_tpu.ops.pallas import decoder_layer as jdl

    rng = np.random.RandomState(pos)
    tree = _layer_tree(rng)
    x, kv, src_k, src_v, mem_bias, lane_bias = _layer_case(pos, pos + 1)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    want_x, want_kv = jdl.decoder_layer_step(
        jnp.asarray(pos, jnp.int32), jnp.asarray(x).astype(jd),
        jnp.asarray(kv).astype(jd), jnp.asarray(src_k).astype(jd),
        jnp.asarray(src_v).astype(jd), jnp.asarray(mem_bias),
        jnp.asarray(lane_bias), jdl.pack_layer_params(tree, jd), lanes=K,
        heads=HEADS, interpret=True)
    packed = pdl.pack_layer_params(_port_layer(tree), td)
    cache = t(kv).to(td)
    got_x, got_kv = pdl.decoder_layer_step(
        pos, t(x).to(td), cache, t(src_k).to(td), t(src_v).to(td),
        t(mem_bias), t(lane_bias), packed, K, HEADS)
    assert got_kv is cache and got_x.dtype == td
    for name, got, want in (("x_out", got_x, want_x),
                            ("kv_cache", got_kv, want_kv)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol * np.abs(want).max(), f"{name}: {err:.3e}"
    # the row at min(pos, S-1) is this step's: the rest of the cache is
    # untouched
    rest = np.delete(np.arange(S), min(pos, S - 1))
    assert torch.equal(got_kv[:, rest], t(kv).to(td)[:, rest])


def test_decoder_layer_pos_past_cap_reads_the_stale_row():
    """Past the cap the stale row S-1 is attended (the TPU kernel's
    semantics, ROADMAP C22): changing it changes the output, while at
    pos < S the stale row at pos does not matter."""
    tree = _layer_tree(np.random.RandomState(5))
    packed = pdl.pack_layer_params(_port_layer(tree), torch.float32)
    for pos, row, moves in ((S + 3, S - 1, True), (7, 7, False)):
        x, kv, src_k, src_v, mem_bias, lane_bias = (
            t(a) for a in _layer_case(pos, 11))
        outs = []
        for shift in (0.0, 3.0):
            cache = kv.clone()
            cache[:, row] += shift
            outs.append(pdl.decoder_layer_step(
                pos, x, cache, src_k, src_v, mem_bias, lane_bias, packed, K,
                HEADS)[0])
        assert (not torch.equal(*outs)) == moves, pos


# ---------------------------------------------------- fused-layer serving


@pytest.fixture(scope="module")
def fused_pair():
    """(JAX, port) Recognizers of the tiny config with decode_fused_layer
    on both sides, the same weights, the port on the CPU."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu_torch.decode.recognizer import Recognizer

    cfg = tiny_cfg()
    cfg.decode_fused_layer = True
    jmodel, variables = jax_tiny_model(cfg, seed=1)
    kw = dict(beam_size=3, t_buckets=(24,), max_decode_tokens=16,
              video_wire="delta2", ctc_weight=0.1)
    return (JaxRecognizer(model=jmodel, variables=variables, cfg=cfg, **kw),
            Recognizer(model=port_model(cfg, variables), cfg=port_cfg(cfg),
                       device="cpu", **kw))


def test_fused_layer_recognizer_matches_jax(fused_pair):
    """Beam tokens identical and scores within 2e-4 relative (as
    tests/test_beam_parity.py holds the JAX fused layer against its
    unfused path), at the JAX default ctc_weight=0.1, three utterances of
    mixed length; the port's decoder really ran decoder_layer_step."""
    jrec, prec = fused_pair
    assert prec.model.decoder.fused_layer
    rng = np.random.RandomState(7)
    lens = (20, 13, 17)
    audio = [rng.randn(n, 104).astype(np.float32) for n in lens]
    video = [rng.randint(0, 256, size=(n, 88, 88, 1)).astype(np.uint8)
             for n in lens]
    aud, vid, ln, _ = jrec._pad_batch(audio, video)
    feats, ctc = jrec._encode_fn()(jrec.variables, aud, vid, ln)
    jy, jl, js = (np.asarray(v) for v in jrec._beam_fn()(
        jrec.variables, feats, ctc, ln))
    calls = []
    real = pdl.decoder_layer_step_plain

    def counted(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    pdl.decoder_layer_step_plain = counted
    try:
        paud, pvid, plens, _ = prec._pad_batch(audio, video)
        py, pl, ps = (v.numpy() for v in prec.beam(
            *prec.encode(paud, pvid, plens), plens))
    finally:
        pdl.decoder_layer_step_plain = real
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(ps, js, rtol=2e-4, atol=0)
    assert len(calls) == 2 * max(lens)  # 2 layers, every step


def test_fused_layer_recognizer_matches_jax_at_beam_10():
    """Beam 10 (ROADMAP C30: above the 8 lanes the fused layer once took),
    the tiny config in fp32 with decode_fused_layer on both sides, three
    utterances of mixed length: tokens and lengths identical, scores within
    2e-4 relative; every step's layers ran decoder_layer_step at 10
    lanes."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu_torch.decode.recognizer import Recognizer

    cfg = tiny_cfg()
    cfg.decode_fused_layer = True
    jmodel, variables = jax_tiny_model(cfg, seed=2)
    kw = dict(beam_size=10, t_buckets=(24,), max_decode_tokens=16,
              video_wire="delta2", ctc_weight=0.1)
    jrec = JaxRecognizer(model=jmodel, variables=variables, cfg=cfg, **kw)
    prec = Recognizer(model=port_model(cfg, variables), cfg=port_cfg(cfg),
                      device="cpu", **kw)
    assert prec.model.decoder.fused_layer
    assert prec.cfg.decoder_param_dtype == prec.cfg.decoder_cache_dtype == (
        "float32")
    rng = np.random.RandomState(11)
    lens = (19, 12, 16)
    audio = [rng.randn(n, 104).astype(np.float32) for n in lens]
    video = [rng.randint(0, 256, size=(n, 88, 88, 1)).astype(np.uint8)
             for n in lens]
    aud, vid, ln, _ = jrec._pad_batch(audio, video)
    feats, ctc = jrec._encode_fn()(jrec.variables, aud, vid, ln)
    jy, jl, js = (np.asarray(v) for v in jrec._beam_fn()(
        jrec.variables, feats, ctc, ln))
    lanes = []
    real = pdl.decoder_layer_step_plain

    def counted(*a, **kw):
        lanes.append(a[8])
        return real(*a, **kw)

    pdl.decoder_layer_step_plain = counted
    try:
        paud, pvid, plens, _ = prec._pad_batch(audio, video)
        py, pl, ps = (v.numpy() for v in prec.beam(
            *prec.encode(paud, pvid, plens), plens))
    finally:
        pdl.decoder_layer_step_plain = real
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(ps, js, rtol=2e-4, atol=0)
    assert lanes and set(lanes) == {10}


# ------------------------------------------------------------ coverage


# every function of avsr_tpu/ops/pallas/ that reaches pl.pallas_call ->
# the port's wrappers of its Hopper counterpart (module, wrapper, source)
PORTED = {
    ("beam_update.py", "beam_update"): [
        ("beam_update", "beam_update", "beam_update.cu")],
    ("decode_attention.py", "decode_attention"): [
        ("decode_attention", "decode_attention", "decode_attention.cu")],
    ("decode_attention.py", "_decode_attention_resident"): [
        ("decode_attention", "decode_attention", "decode_attention.cu")],
    ("decoder_layer.py", "decoder_layer_step"): [
        ("decoder_layer", "decoder_layer_step", "decoder_layer.cu")],
    ("flash_attention.py", "_fwd_impl_resident"): [
        ("flash_attention", "flash_attention_fwd", "flash_attention.cu")],
    ("flash_attention.py", "_fwd_impl"): [
        ("flash_attention", "flash_attention_fwd", "flash_attention.cu")],
    ("flash_attention.py", "_bwd_impl_resident"): [
        ("flash_attention", "flash_attention_bwd_dq",
         "flash_attention_bwd.cu"),
        ("flash_attention", "flash_attention_bwd_dkv",
         "flash_attention_bwd.cu")],
    ("flash_attention.py", "_bwd_impl"): [
        ("flash_attention", "flash_attention_bwd_dq",
         "flash_attention_bwd.cu"),
        ("flash_attention", "flash_attention_bwd_dkv",
         "flash_attention_bwd.cu")],
    ("row_gather.py", "row_gather"): [
        ("row_gather", "row_gather", "row_gather.cu"),
        ("topk", "topk_gather_rows", "topk.cu")],
    ("scan_logsumexp.py", "cumlogsumexp"): [
        ("scan_logsumexp", "cumlogsumexp", "scan_logsumexp.cu")],
    ("stem_fuse.py", "_batch_stats"): [
        ("stem_fuse", "bn_prelu_pool_stats", "stem_fuse.cu")],
    ("stem_fuse.py", "_apply"): [
        ("stem_fuse", "bn_prelu_pool_apply", "stem_fuse.cu")],
    ("stem_fuse.py", "_train_bwd"): [
        ("stem_fuse", "bn_prelu_pool_bwd1", "stem_fuse.cu"),
        ("stem_fuse", "bn_prelu_pool_bwd2", "stem_fuse.cu")],
    ("topk.py", "topk_lastdim"): [("topk", "topk_lastdim", "topk.cu")],
}


def _pallas_call_sites():
    """{(file, innermost top-level or nested function)} of every
    pl.pallas_call under avsr_tpu/ops/pallas/, selfcheck.py aside."""
    sites = set()
    for path in sorted((REPO / "avsr_tpu" / "ops" / "pallas").glob("*.py")):
        if path.name in ("__init__.py", "selfcheck.py"):
            continue
        tree = ast.parse(path.read_text())

        def visit(node, func):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "pallas_call"):
                sites.add((path.name, func))
            for child in ast.iter_child_nodes(node):
                visit(child, func)

        visit(tree, None)
    return sites


def test_every_pallas_kernel_has_a_hopper_counterpart():
    """Each pl.pallas_call site maps to port wrappers that count their
    launches (``.launches``, an int) and whose C entry point lives in a
    csrc/*.cu source; no site is pending and no mapping is stale."""
    sites = _pallas_call_sites()
    assert len(sites) >= 14
    assert sites == set(PORTED), (
        f"unmapped: {sorted(sites - set(PORTED))}; "
        f"stale: {sorted(set(PORTED) - sites)}")
    csrc = REPO / "avsr_tpu_torch" / "csrc"
    for site, wrappers in PORTED.items():
        for module, name, source in wrappers:
            mod = importlib.import_module(
                f"avsr_tpu_torch.ops.kernels.{module}")
            fn = getattr(mod, name)
            assert isinstance(fn.launches, int), (site, name)
            text = (csrc / source).read_text()
            assert 'extern "C"' in text and "__global__" in text, source
            wrapper_src = pathlib.Path(mod.__file__).read_text()
            entries = [e for e in _c_entry_points(text) if e in wrapper_src]
            assert entries, (site, name, source)


def _c_entry_points(text):
    out = []
    for part in text.split('extern "C"')[1:]:
        head = part.split("(")[0].split()
        out.append(head[-1])
    return out


def test_decode_fused_layer_selects_the_cache_layout():
    """decode_fused_layer defaults off, as in the JAX package; with it off
    the decoder's cache holds the unfused per-layer weights."""
    from avsr_tpu_torch.core.config import AVHubertAVSRConfig
    from avsr_tpu_torch.models.decoder import LayerParams

    assert not AVHubertAVSRConfig().decode_fused_layer
    cfg = tiny_cfg()
    model = port_model(cfg, jax_tiny_model(cfg)[1])
    assert not model.decoder.fused_layer
    cache = model.decoder_init(torch.zeros(1, 5, 32), 16, 3)
    assert isinstance(cache.params[0], LayerParams)
    assert cache.src_k[0].shape == (1, 4, 5, 8)
    fused = dataclasses.replace(port_cfg(cfg), decode_fused_layer=True)
    from avsr_tpu_torch.models.e2e import AVSRModel

    fm = AVSRModel(fused)
    fm.load_state_dict(model.state_dict())
    cache = fm.decoder_init(torch.zeros(1, 5, 32), 16, 3)
    assert isinstance(cache.params[0], pdl.PackedLayer)
    assert cache.src_k[0].shape == (1, 5, 32)
