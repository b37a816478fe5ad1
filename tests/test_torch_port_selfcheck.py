"""The port's kernel self-check (``avsr_tpu_torch/ops/kernels/selfcheck.py``)
on the CPU.

Its cases against the JAX Pallas kernels in interpret mode: the
self-check's own inputs (the JAX self-check's seeds) go through the JAX
function and the port's twin, under the self-check's rule. On the CPU the
wrappers are the twins, so the checks themselves are tested by perturbing
one wrapper's result at a time: the check must raise, naming the kernel.
Only the card checks a kernel (``python -m
avsr_tpu_torch.tools.kernel_smoke``).
"""

import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.ops.kernels import beam_update as pbu  # noqa: E402
from avsr_tpu_torch.ops.kernels import ctc_loss as pcl  # noqa: E402
from avsr_tpu_torch.ops.kernels import decode_attention as pda  # noqa: E402
from avsr_tpu_torch.ops.kernels import flash_attention as pfa  # noqa: E402
from avsr_tpu_torch.ops.kernels import row_gather as prg  # noqa: E402
from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl  # noqa: E402
from avsr_tpu_torch.ops.kernels import selfcheck as sc  # noqa: E402
from avsr_tpu_torch.ops.kernels import stem_fuse as psf  # noqa: E402
from avsr_tpu_torch.ops.kernels import topk as ptk  # noqa: E402
from tests.torch_port_common import setup_torch, t  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


@pytest.fixture(scope="module")
def serving():
    return sc.serving_inputs()


# ------------------------------------------------ the cases against JAX


def test_topk_cases_match_jax(serving):
    """(32, 3, 5049) k=4 and (32, 39) k=3: values and ids bit for bit."""
    from avsr_tpu.ops.pallas.topk import topk_lastdim

    for name, k in (("topk", 4), ("flat", 3)):
        want_v, want_i = topk_lastdim(serving[name], k, interpret=True)
        got_v, got_i = ptk.topk_plain(t(serving[name]), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_scan_case_matches_jax(serving):
    """(375, 96) within the check's 1e-5."""
    from avsr_tpu.ops.pallas.scan_logsumexp import cumlogsumexp

    want = cumlogsumexp(serving["scan"], interpret=True)
    got = psl.cumlogsumexp_plain(t(serving["scan"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gather_case_matches_jax(serving):
    """(4096, 384) with the TPU kernel's ring + 72 ids, bit for bit."""
    from avsr_tpu.ops.pallas.row_gather import _RING, row_gather

    assert sc.RING == _RING
    want = row_gather(jnp.asarray(serving["src"]), jnp.asarray(serving["idx"]),
                      interpret=True)
    got = prg.row_gather_plain(t(serving["src"]), t(serving["idx"]).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam_case_matches_jax(serving):
    """b=32, k=3, sp=4, L=377, S=192 at step 5: every selection equal, the
    float outputs within 2 ulps of their largest entry (ROADMAP C14: XLA's
    CPU backend contracts w_dec*a + w_ctc*b into an FMA; the ulp of a term
    is up to 8 ulps of a smaller sum here)."""
    from avsr_tpu.ops.pallas.beam_update import beam_update

    args = {k: jnp.asarray(v) for k, v in serving["beam"].items()}
    want = beam_update(i=jnp.asarray(sc.SERVE["i"], jnp.int32), **args,
                       penalty=0.0, lazy=True, interpret=True, **sc.BEAM_KW)
    got = pbu.beam_update_plain(sc.SERVE["i"],
                                **sc.beam_tensors(serving["beam"], "cpu"),
                                **sc.BEAM_KW)
    assert set(got) == set(want)
    for name, g in got.items():
        g, w = g.numpy(), np.asarray(want[name])
        if name in ("score", "best_score", "ended_best"):
            top = np.abs(w[np.abs(w) < 1e29]).max()
            np.testing.assert_allclose(g, w, rtol=0, err_msg=name,
                                       atol=2 * np.spacing(top))
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_decode_case_matches_jax():
    """The check's decode step at B=4 (12 lanes) instead of 32 (96 lanes;
    JAX's interpret mode takes ~8 s there), S=192, 16x64 heads, pos 37,
    fp32: the written row bit for bit, the output within
    ``output_bound``."""
    from avsr_tpu.ops.pallas.decode_attention import decode_attention

    x = sc.serving_inputs(b=4)
    pos, k, heads = sc.SERVE["pos"], sc.SERVE["k"], sc.SERVE["heads"]
    want, want_kv = decode_attention(
        jnp.asarray(pos), jnp.asarray(x["q"]), jnp.asarray(x["kv"]),
        jnp.asarray(x["lane_bias"]), lanes=k, heads=heads,
        kv_row=jnp.asarray(x["row"]), resident=True, interpret=True)
    q, kv, lb, row = (t(x[n]) for n in ("q", "kv", "lane_bias", "row"))
    got, got_kv = pda.decode_attention_plain(pos, q, kv.clone(), lb, k,
                                             heads, row)
    np.testing.assert_array_equal(got_kv.numpy(), np.asarray(want_kv))
    bound = pda.output_bound(pos, q, kv, lb, k, heads, row).numpy()
    assert (np.abs(got.numpy() - np.asarray(want)) <= bound).all()


def test_stem_eval_case_matches_jax():
    """The eval tail in bf16 at (64, 44, 44, 64) within the check's 2e-2."""
    from avsr_tpu.ops.pallas import stem_fuse

    a = sc.stem_inputs(False)
    xb = jnp.asarray(a["x"]).astype(jnp.bfloat16)
    want = stem_fuse.bn_prelu_pool(
        xb, *(jnp.asarray(a[k]) for k in ("scale", "bias", "alpha")),
        train=False, running_mean=jnp.asarray(a["rm"]),
        running_var=jnp.asarray(a["rv"]), interpret=True)
    got = psf.bn_prelu_pool_plain(
        sc._frames(a["x"], "cpu", torch.bfloat16),
        *(t(a[k]) for k in ("scale", "bias", "alpha")), train=False,
        running_mean=t(a["rm"]), running_var=t(a["rv"]))
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want.astype(jnp.float32)), rtol=2e-2, atol=2e-2)


def test_stem_train_case_matches_jax():
    """The training tail's loss and four gradients at a block of 16 frames
    instead of 64 (JAX's interpret mode takes ~4 s at 64), the same
    H, W and C, within the check's limits (loss 1e-3, gradients 2e-2
    relative + 2e-3)."""
    from avsr_tpu.ops.pallas import stem_fuse

    a = sc.stem_inputs(True, block=(16, 44, 44, 64))
    wgt = jnp.asarray(a["wgt"])

    def loss(x, s, b, al):
        out, _, _ = stem_fuse.bn_prelu_pool(x, s, b, al, train=True,
                                            interpret=True)
        return jnp.vdot(out.astype(jnp.float32), wgt)

    names = ("x", "scale", "bias", "alpha")
    want, wgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a[k]) for k in names))
    x = sc._frames(a["x"], "cpu").requires_grad_(True)
    params = [t(a[k]).requires_grad_(True) for k in names[1:]]
    out = psf.bn_prelu_pool(x, *params, train=True)[0]
    got = (out * sc._frames(a["wgt"], "cpu")).sum()
    grads = torch.autograd.grad(got, [x, *params])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-3)
    grads = [grads[0].permute(0, 2, 3, 1)] + list(grads[1:])
    for name, g, w in zip(names, grads, wgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-2,
                                   atol=2e-3, err_msg=f"d{name}")


def test_flash_case_matches_jax():
    """The check's T=256 draws (``RandomState(7)``) on the first 4 of its
    16 heads (JAX's interpret mode takes ~4 s at 16), dropout 0.3 at the
    check's seed: JAX is given the port's pre-scaled Philox mask. The
    output and dQ, dK, dV within the check's fp32 limit, 1e-4 of the
    largest entry."""
    from avsr_tpu.ops.pallas.flash_attention import flash_attention

    n, t_len, d = 4, 256, sc.FLASH["d"]
    rng = np.random.RandomState(7)
    q, k, v = (x[:n] for x in sc.flash_inputs(t_len, rng))
    w = rng.randn(sc.FLASH["n"], t_len, d).astype(np.float32)[:n]
    rate, seed, scale = sc.FLASH["rate"], sc.FLASH["seed"], d ** -0.5
    mask = pfa._seeded_mask(rate, seed, sc.FLASH["n"], t_len, "cpu")[:n]
    bias = np.zeros((n, t_len), np.float32)

    def f(q, k, v):
        return flash_attention(q, k, v, jnp.asarray(bias), scale=scale,
                               interpret=True,
                               dropout_mask=jnp.asarray(mask.numpy()))

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    wants = vjp(jnp.asarray(w))
    # the twins with the check's mask: the draw the kernels make
    got, lse = pfa.flash_attention_plain(t(q), t(k), t(v), t(bias), scale,
                                         dropout_mask=mask)
    grads = pfa.flash_attention_bwd_plain(t(q), t(k), t(v), t(bias), got,
                                          t(w), lse, scale,
                                          dropout_mask=mask)
    for name, g, ref in zip(("out", "dq", "dk", "dv"), (got, *grads),
                            (want, *wants)):
        ref = np.asarray(ref)
        err = np.abs(g.numpy() - ref).max()
        assert err <= sc.FLASH_TOL[torch.float32] * np.abs(ref).max(), name


# ------------------------------------------------ the checks themselves


def _shift(fn, what, delta):
    """``fn`` with ``delta`` added to the result ``what`` picks out."""
    def perturbed(*args, **kwargs):
        out = fn(*args, **kwargs)
        return what(out, delta)
    return perturbed


def _first(out, d):
    return (out[0] + d, *out[1:])


def _second(out, d):
    return (out[0], out[1] + d, *out[2:])


def _third(out, d):
    return (*out[:2], out[2] + d, *out[3:])


def _score(out, d):
    return {**out, "score": out["score"] + d}


PERTURBED = {
    # kernel named in the failure: (module, wrapper, how, delta, check)
    "topk_lastdim": (ptk, "topk_lastdim", _first, 1e-3, "topk"),
    "cumlogsumexp": (psl, "cumlogsumexp", lambda o, d: o + d, 1e-3,
                     "scan"),
    "row_gather": (prg, "row_gather", lambda o, d: o + d, 1.0, "gather"),
    "beam_update": (pbu, "beam_update", _score, 1.0, "beam"),
    "decode_attention": (pda, "decode_attention", _first, 1e-2, "decode"),
    "topk_gather_rows": (ptk, "topk_gather_rows", _third, 1.0,
                         "topk_gather"),
    "bn_prelu_pool": (psf, "bn_prelu_pool", None, 0.5, "stem"),
    "flash_attention_fwd": (pfa, "flash_attention_fwd", _first, 1e-2,
                            "flash"),
    "flash_attention_bwd_dq": (pfa, "flash_attention_bwd_dq", _first, 1e-2,
                               "flash"),
    "flash_attention_bwd_dkv": (pfa, "flash_attention_bwd_dkv", _second,
                                1e-2, "flash"),
    "ctc_loss_fwd": (pcl, "ctc_loss_fwd", _first, 1e-3, "ctc"),
    "ctc_loss_bwd": (pcl, "ctc_loss_bwd", lambda o, d: o + d, 1e-3, "ctc"),
}


CASES = [(k, False) for k in sorted(PERTURBED)] + [("bn_prelu_pool", True)]


@pytest.mark.parametrize("kernel,train", CASES)
def test_a_perturbed_kernel_fails_its_check(kernel, train, serving,
                                            monkeypatch):
    """One wrapper's result moved by a small amount (a top-k value by
    1e-3, a scan by 1e-3, an attention output or gradient by 1e-2, the
    CTC loss's NLL or gradient by 1e-3): its check raises AssertionError
    naming that kernel, and the unperturbed check passes. The stem tail
    is moved in eval and in training."""
    module, name, how, delta, check = PERTURBED[kernel]
    run = {
        "stem": lambda: sc.check_stem_fuse(train, "cpu"),
        "flash": lambda: sc.check_flash(256, torch.float32,
                                        np.random.RandomState(7), "cpu"),
        "ctc": lambda: sc.check_ctc_loss("cpu"),
    }.get(check) or (lambda: getattr(sc, f"check_{check}")(serving, "cpu"))
    run()
    if how is None:  # the stem: eval returns out, training (out, m, v)
        how = _first if train else (lambda o, d: o + d)
    monkeypatch.setattr(module, name,
                        _shift(getattr(module, name), how, delta))
    with pytest.raises(AssertionError, match=f"^{kernel}: "):
        run()


def test_checks_run_clean_on_the_cpu(monkeypatch):
    """Both entry points end without a failure on the CPU, where every
    wrapper is its twin: the serving check at its shapes, the training
    check at T=256 only (its T=640 case costs ~8 s on the CPU)."""
    sc.check_serving_kernels("cpu")
    monkeypatch.setitem(sc.FLASH, "lengths", (256,))
    sc.check_train_kernels("cpu")


def test_every_kernel_module_is_selfchecked_or_exempt():
    """As ``tests/test_robustness.py`` guards ``avsr_tpu/ops/pallas/``:
    every kernel module of the port is imported by the self-check or
    carries a ``SELFCHECK-EXEMPT:`` reason; the port's decoder layer
    carries the JAX package's."""
    kdir = pathlib.Path(sc.__file__).parent
    src = (kdir / "selfcheck.py").read_text()
    missing = []
    for mod in sorted(kdir.glob("*.py")):
        if mod.stem in ("__init__", "_build", "selfcheck"):
            continue
        if (f"kernels import {mod.stem} as" not in src
                and "SELFCHECK-EXEMPT:" not in mod.read_text()):
            missing.append(mod.stem)
    assert not missing, missing
    jax_layer = pathlib.Path(__file__).parents[1] / (
        "avsr_tpu/ops/pallas/decoder_layer.py")
    assert "SELFCHECK-EXEMPT:" in jax_layer.read_text()
    assert "SELFCHECK-EXEMPT:" in (kdir / "decoder_layer.py").read_text()
