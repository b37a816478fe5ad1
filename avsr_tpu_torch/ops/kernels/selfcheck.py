"""Self-check of the port's kernels against their plain twins.

Counterpart of ``avsr_tpu/ops/pallas/selfcheck.py``: each kernel runs once
on ``device`` at the JAX self-check's shapes and seeds, and its wrapper's
result is held against the plain PyTorch twin on the same inputs. Any
mismatch, build or launch failure raises; a failed case raises
``AssertionError`` naming the kernel and the case.

- ``check_stem_fuse(train, device)``: the fused stem tail (B7) at the real
  block (64, 44, 44, 64): eval in bf16 within 2e-2, training's loss within
  1e-3 and its four gradients within 2e-2 relative + 2e-3 absolute;
- ``check_serving_kernels(device)``: the eval stem tail; top-k (B5) on
  (32, 3, 5049) k=4 and (32, 39) k=3, values and ids bit for bit;
  ``cumlogsumexp`` (B3) on (375, 96) within 1e-5; ``row_gather`` (B4) on
  (4096, 384) with ``RING`` + 72 ids, bit for bit; ``beam_update`` (B8) at
  b=32, k=3, sp=4, L=377, S=192, every output bit for bit;
  ``decode_attention`` (B2) at 96 lanes, S=192, 16x64 heads, pos 37, fp32:
  the written K|V row bit for bit, the output within ``output_bound``; and
  the pre-beam top-k that gathers the CTC rows in its launch
  (``topk_gather_rows``, B5 with B4's rows) on the same (32, 3, 5049),
  ids and rows bit for bit;
- ``check_train_kernels(device)``: the training stem tail, then flash
  attention (B1, B6) with dropout 0.3 at N=16, T=256 and 640, D=64, in
  fp32 (the JAX check's type) and bf16 (the training path's):
  deterministic, linear in V (2v gives 2 out), a keep rate within 0.01 of
  0.7 and a keep pattern equal to the twin's Philox draw (read out of the
  kernel with q = k = 0 and V = T x identity blocks), the output and the
  three gradients within 1e-4 (fp32) or 2e-2 (bf16) of the twin's largest
  entry; then the CTC loss (``ctc_loss_fwd``, ``ctc_loss_bwd``; no JAX
  check, as it has no Pallas kernel) at B=4, T=120, V=41, L=20 with a
  shorter, an infeasible and a repeated-label sample, given the twins'
  log-probs: deterministic, keep equal, the NLL within 1e-6 relative and
  the gradient within 1e-6 of the twin's largest entry, the infeasible
  sample 0.

The step of ``beam_update`` and ``decode_attention`` goes in as the
(1,) int32 device tensor that the beam's device loop hands them.

How the port differs: the JAX checks compare a kernel compiled for the
TPU with the same kernel in interpret mode, and ``check_train_kernels``
returns at once on the CPU. Here every check runs on any device: on a CPU
device each wrapper takes its CPU route, which is its twin, so only the
checks' own code is tested there; only a CUDA device checks a kernel.
``decoder_layer`` (B9) is exempt, as it is in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from avsr_tpu_torch.ops.kernels import _build
from avsr_tpu_torch.ops.kernels import beam_update as pbu
from avsr_tpu_torch.ops.kernels import ctc_loss as pcl
from avsr_tpu_torch.ops.kernels import decode_attention as pda
from avsr_tpu_torch.ops.kernels import flash_attention as pfa
from avsr_tpu_torch.ops.kernels import row_gather as prg
from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl
from avsr_tpu_torch.ops.kernels import stem_fuse as psf
from avsr_tpu_torch.ops.kernels import topk as ptk

RING = 128  # avsr_tpu/ops/pallas/row_gather.py _RING: the DMA ring's depth
STEM_BLOCK = (64, 44, 44, 64)  # (N, H, W, C) of the serving and train block
SERVE = dict(b=32, k=3, sp=4, ll=377, s_kv=192, heads=16, dh=64, pos=37,
             i=5, vocab=5049)
BEAM_KW = dict(w_dec=0.9, w_ctc=0.1, eos=5048, neg=-1.0e30, d_end=-10.0,
               m_end=3)
FLASH = dict(n=16, d=64, rate=0.3, seed=(123, 456), lengths=(256, 640))
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the CTC loss's case: both sides run the recursions in float64
CTC = dict(b=4, t=120, v=41, l=20, seed=25)
CTC_TOL = 1e-6
LINEAR_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _fail(kernel: str, case: str, what: str) -> AssertionError:
    return AssertionError(f"{kernel}: {case}: {what}")


def _equal(kernel: str, case: str, got, want) -> None:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise _fail(kernel, case, f"{got.dtype} {tuple(got.shape)} against "
                                  f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise _fail(kernel, case, f"{bad} of {want.numel()} elements differ")


def _close(kernel: str, case: str, got, want, rtol: float,
           atol: float) -> None:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    if got.shape != want.shape or not bool((err <= lim).all()):
        raise _fail(kernel, case, f"max abs err {err.max().item():.3e} "
                                  f"beyond {atol:g} + {rtol:g} |want|")


def _near_largest(kernel: str, case: str, got, want, tol: float) -> None:
    """The largest error held within ``tol`` of want's largest entry."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    if not err <= tol * top:
        raise _fail(kernel, case, f"max abs err {err:.3e} beyond {tol:g} x "
                                  f"{top:.3e}")


def _t(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# ---------------------------------------------------------------- inputs


def stem_inputs(train: bool, block=STEM_BLOCK) -> dict:
    """The JAX check's draws from ``RandomState(3)``: x (N, H, W, C), scale,
    bias, alpha and, for eval, the running mean and var; for training the
    loss weights (N, H/2, W/2, C). NHWC, as the TPU kernel takes them."""
    rng = np.random.RandomState(3)
    n, h, w, c = block
    out = {
        "x": rng.randn(n, h, w, c).astype(np.float32) * 0.5,
        "scale": 1.0 + 0.1 * rng.randn(c).astype(np.float32),
        "bias": 0.1 * rng.randn(c).astype(np.float32),
        "alpha": np.full((c,), 0.25, np.float32),
    }
    if train:
        out["wgt"] = rng.randn(n, h // 2, w // 2, c).astype(np.float32)
    else:
        out["rm"] = 0.1 * rng.randn(c).astype(np.float32)
        out["rv"] = 0.5 + np.abs(rng.randn(c)).astype(np.float32)
    return out


def _frames(x, device, dtype=torch.float32):
    """NHWC numpy -> (N, C, H, W) channels-last, the stem's own layout."""
    return _t(x, device).to(dtype).permute(0, 3, 1, 2)


def serving_inputs(b: int = SERVE["b"]) -> dict:
    """The JAX serving check's draws from ``RandomState(0)``, in its order,
    for ``b`` utterances: top-k rows, the flat rows, the scan, the gather,
    the bookkeeping step's state and the decode step's q, cache, row and
    ancestry (each array as numpy, in the TPU kernel's layout); then,
    after all of JAX's draws, the CTC table that ``topk_gather_rows``
    gathers from."""
    rng = np.random.RandomState(0)
    k, sp, dh, pos = SERVE["k"], SERVE["sp"], SERVE["dh"], SERVE["pos"]
    ll, s_kv, heads, vocab = (SERVE[n] for n in ("ll", "s_kv", "heads",
                                                  "vocab"))
    x = {"topk": rng.randn(b, k, vocab).astype(np.float32),
         "flat": rng.randn(b, 39).astype(np.float32),
         "scan": (rng.randn(375, 96) * 4.0).astype(np.float32),
         "src": rng.randn(4096, 384).astype(np.float32)}
    x["idx"] = rng.randint(0, 4096, size=(RING + 72,)).astype(np.int32)
    beam = dict(
        xlens=rng.randint(4, 370, size=(b,)).astype(np.int32),
        dec_top=np.sort(rng.randn(b, k, sp).astype(np.float32),
                        axis=-1)[..., ::-1].copy(),
        dec_eos=rng.randn(b, k).astype(np.float32) - 5,
        psi_cand=rng.randn(b, k, sp).astype(np.float32),
        psi_eos=rng.randn(b, k).astype(np.float32),
        ctc_s=rng.randn(b, k).astype(np.float32),
        part_ids=rng.randint(1, vocab, size=(b, k, sp)).astype(np.int32),
        score=rng.randn(b, k).astype(np.float32),
        alive=rng.rand(b, k) > 0.2,
        stop=rng.rand(b) > 0.9,
        yseq=rng.randint(0, vocab, size=(b, k, ll)).astype(np.int32),
        anc=rng.randint(0, k, size=(s_kv, b, k)).astype(np.int32),
        ended_best=rng.randn(b, ll).astype(np.float32),
        ended_cnt=rng.randint(0, 3, size=(b, ll)).astype(np.int32),
        best_score=rng.randn(b).astype(np.float32),
        best_yseq=rng.randint(0, vocab, size=(b, ll)).astype(np.int32),
        best_len=rng.randint(0, ll, size=(b,)).astype(np.int32),
    )
    x["beam"] = beam
    n, c = b * k, heads * dh
    x["q"] = rng.randn(n, c).astype(np.float32)
    x["kv"] = rng.randn(n, s_kv, 2 * c).astype(np.float32)
    x["row"] = rng.randn(n, 2 * c).astype(np.float32)
    anc = rng.randint(0, k, size=(s_kv, b, k))
    anc[pos] = np.arange(k)[None, :]
    valid = (np.arange(s_kv) <= pos)[:, None, None, None] & (
        anc[..., None] == np.arange(k))
    x["lane_bias"] = np.where(np.transpose(valid, (1, 2, 0, 3)), 0.0,
                              -1.0e30).astype(np.float32)
    x["table"] = rng.randn(b * vocab, 16).astype(np.float32)
    return x


def beam_tensors(beam: dict, device) -> dict:
    """The bookkeeping state in the port's types: ids and counts int64,
    masks bool, floats fp32."""
    out = {}
    for name, v in beam.items():
        v = _t(v, device)
        out[name] = v if v.dtype in (torch.bool, torch.float32) else v.long()
    return out


def flash_inputs(t: int, rng: np.random.RandomState) -> tuple:
    """The JAX check's q, k, v (N, T, D) for length t, drawn from the
    check's one ``RandomState(7)`` in its order (the loss weights come
    next)."""
    n, d = FLASH["n"], FLASH["d"]
    q = rng.randn(n, t, d).astype(np.float32) * 0.3
    k = rng.randn(n, t, d).astype(np.float32) * 0.3
    v = rng.randn(n, t, d).astype(np.float32)
    return q, k, v


# ---------------------------------------------------------------- checks


def check_stem_fuse(train: bool, device="cuda") -> None:
    """The fused stem tail at the real block shape: the eval apply in bf16
    (the serving path), or the training forward and its four gradients in
    fp32, each against the twin on the same inputs."""
    a = stem_inputs(train)
    s, b, al = (_t(a[k], device) for k in ("scale", "bias", "alpha"))
    if not train:
        xb = _frames(a["x"], device, torch.bfloat16)
        rm, rv = _t(a["rm"], device), _t(a["rv"], device)
        kw = dict(train=False, running_mean=rm, running_var=rv)
        got = psf.bn_prelu_pool(xb, s, b, al, **kw)
        want = psf.bn_prelu_pool_plain(xb, s, b, al, **kw)
        _close("bn_prelu_pool", "eval bf16 (64, 44, 44, 64)", got, want,
               2e-2, 2e-2)
        return
    wgt = _frames(a["wgt"], device)

    def value_and_grads(fn):
        x = _frames(a["x"], device).detach().requires_grad_(True)
        params = [p.clone().requires_grad_(True) for p in (s, b, al)]
        out = fn(x, *params, train=True)[0]
        loss = (out.float() * wgt).sum()
        return loss.detach(), torch.autograd.grad(loss, [x, *params])

    got = value_and_grads(psf.bn_prelu_pool)
    want = value_and_grads(psf.bn_prelu_pool_plain)
    case = "train fp32 (64, 44, 44, 64)"
    _close("bn_prelu_pool", case + " loss", got[0], want[0], 1e-3, 0.0)
    for name, g, w in zip(("x", "scale", "bias", "alpha"), got[1], want[1]):
        _close("bn_prelu_pool", f"{case} d{name}", g, w, 2e-2, 2e-3)


def check_topk(x: dict, device) -> None:
    """B5 on the pre-beam rows and the flat rows, bit for bit."""
    for case, name, kk in (("(32, 3, 5049) k=4", "topk", 4),
                           ("(32, 39) k=3", "flat", 3)):
        inp = _t(x[name], device)
        got, want = ptk.topk_lastdim(inp, kk), ptk.topk_plain(inp, kk)
        _equal("topk_lastdim", case + " ids", got[1], want[1])
        _equal("topk_lastdim", case + " values", got[0], want[0])


def check_scan(x: dict, device) -> None:
    """B3 on (375, 96) within 1e-5."""
    xs = _t(x["scan"], device)
    _close("cumlogsumexp", "(375, 96)", psl.cumlogsumexp(xs),
           psl.cumlogsumexp_plain(xs), 1e-5, 1e-5)


def check_gather(x: dict, device) -> None:
    """B4 on (4096, 384) with more ids than the TPU kernel's ring."""
    src, idx = _t(x["src"], device), _t(x["idx"], device).long()
    _equal("row_gather", f"(4096, 384), {RING + 72} ids",
           prg.row_gather(src, idx), prg.row_gather_plain(src, idx))


def check_beam(x: dict, device) -> None:
    """B8 at the serving configuration, every output bit for bit."""
    step = _build.device_step(SERVE["i"], device)
    st = beam_tensors(x["beam"], device)
    got = pbu.beam_update(step, **st, **BEAM_KW)
    want = pbu.beam_update_plain(step, **st, **BEAM_KW)
    for name in pbu._OUT:
        _equal("beam_update", f"b=32 k=3 sp=4 L=377 S=192 {name}",
               got[name], want[name])


def check_decode(x: dict, device) -> None:
    """B2 at 96 lanes: the row write bit for bit, the output within
    ``output_bound`` of the twin's."""
    q, row, lb = (_t(x[n], device) for n in ("q", "row", "lane_bias"))
    kv = _t(x["kv"], device)
    step = _build.device_step(SERVE["pos"], device)
    k, heads = SERVE["k"], SERVE["heads"]
    out, cache = pda.decode_attention(step, q, kv.clone(), lb, k, heads, row)
    w_out, w_cache = pda.decode_attention_plain(step, q, kv.clone(), lb, k,
                                                heads, row)
    case = "96 lanes, S=192, 16x64 heads, pos 37, fp32"
    _equal("decode_attention", case + " K|V row write", cache, w_cache)
    bound = pda.output_bound(step, q, kv, lb, k, heads, row)
    err = (out - w_out).abs()
    if out.shape != w_out.shape or not bool((err <= bound).all()):
        raise _fail("decode_attention", case,
                    f"max abs err {err.max().item():.3e}, "
                    f"{int((err > bound).sum())} outputs beyond output_bound")


def check_topk_gather(x: dict, device) -> None:
    """B5 with B4's rows in one launch: ids, values and rows bit for bit
    against the twins' top-k and gather."""
    xt, table = _t(x["topk"], device), _t(x["table"], device)
    vals, ids, rows = ptk.topk_gather_rows(xt, 4, table)
    w_vals, w_ids = ptk.topk_plain(xt, 4)
    base = torch.arange(xt.shape[0], device=xt.device)[:, None, None]
    case = "(32, 3, 5049) k=4, (32*5049, 16) table"
    _equal("topk_gather_rows", case + " ids", ids, w_ids)
    _equal("topk_gather_rows", case + " values", vals, w_vals)
    _equal("topk_gather_rows", case + " rows", rows, prg.row_gather_plain(
        table, (w_ids + base * xt.shape[2]).view(-1)))


SERVING_CHECKS = (check_topk, check_scan, check_gather, check_beam,
                  check_decode, check_topk_gather)


def check_serving_kernels(device="cuda") -> None:
    """Every serving kernel of the JAX check at its shapes, and the
    pre-beam top-k with the CTC rows, against the twins."""
    check_stem_fuse(False, device)
    x = serving_inputs()
    for check in SERVING_CHECKS:
        check(x, device)


def _read_mask(f, n: int, t: int, d: int, dtype, device):
    """The kernel's applied dropout mask (N, T, T), read out: with q = k =
    0 and a zero bias the attention is uniform, out = (1/T) M V, and V = T
    x identity blocks places M's columns j0..j0+d-1 in the output."""
    z = torch.zeros(n, t, d, device=device, dtype=dtype)
    cols = []
    for j0 in range(0, t, d):
        w = min(d, t - j0)
        vb = torch.zeros(n, t, d, device=device)
        vb[:, j0:j0 + w, :w] = torch.eye(w, device=device) * t
        cols.append(f(z, z, vb.to(dtype))[..., :w].float())
    return torch.cat(cols, dim=2)


def check_flash(t: int, dtype, rng: np.random.RandomState,
                device="cuda") -> None:
    """Flash attention with dropout at N=16, length t, D=64 in ``dtype``."""
    n, d, rate, seed = FLASH["n"], FLASH["d"], FLASH["rate"], FLASH["seed"]
    scale = d ** -0.5
    case = f"N={n} T={t} D={d} {str(dtype)[6:]} dropout {rate}"
    q, k, v = (_t(a, device).to(dtype) for a in flash_inputs(t, rng))
    w = _t(rng.randn(n, t, d).astype(np.float32), device)
    bias = torch.zeros(n, t, device=device)

    def f(q, k, v):
        return pfa.flash_attention(q, k, v, bias, scale=scale,
                                   dropout_rate=rate, dropout_seed=seed)

    out1, out2 = f(q, k, v), f(q, k, v)
    _equal("flash_attention_fwd", case + " determinism", out2, out1)
    _close("flash_attention_fwd", case + " 2v against 2 out", f(q, k, 2 * v),
           2 * out1, LINEAR_TOL[dtype], LINEAR_TOL[dtype])
    ones = f(torch.zeros_like(q), torch.zeros_like(k),
             torch.ones_like(v)).float()
    if not abs(ones.mean().item() - 1.0) < 0.02 or not ones.std() > 1e-3:
        raise _fail("flash_attention_fwd", case, f"all-ones V gives mean "
                    f"{ones.mean().item():.4f}, std {ones.std().item():.2e}")
    kept = _read_mask(f, n, t, d, dtype, device) > 0.5
    frac = kept.float().mean().item()
    if not abs(frac - (1.0 - rate)) < 0.01:
        raise _fail("flash_attention_fwd", case, f"keep fraction {frac:.4f}")
    _equal("flash_attention_fwd", case + " keep pattern against the draw",
           kept, pfa.dropout_keep_mask_plain(seed, n, t, rate, q.device))

    w_out, lse = pfa.flash_attention_plain(q, k, v, bias, scale,
                                           dropout_rate=rate,
                                           dropout_seed=seed)
    tol = FLASH_TOL[dtype]
    _near_largest("flash_attention_fwd", case + " out", out1, w_out, tol)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    loss = (f(qg, kg, vg).float() * w).sum()
    grads = torch.autograd.grad(loss, (qg, kg, vg))
    wants = pfa.flash_attention_bwd_plain(q, k, v, bias, w_out, w.to(dtype),
                                          lse, scale, dropout_rate=rate,
                                          dropout_seed=seed)
    for kernel, name, g, want in (
            ("flash_attention_bwd_dq", "dq", grads[0], wants[0]),
            ("flash_attention_bwd_dkv", "dk", grads[1], wants[1]),
            ("flash_attention_bwd_dkv", "dv", grads[2], wants[2])):
        _near_largest(kernel, f"{case} {name}", g, want, tol)


def ctc_inputs() -> tuple:
    """Logits (B, T, V) of std 2, labels (B, L) with a run of three
    equal labels, padded with -1, and the lengths: sample 1 shorter,
    sample 2 infeasible (T = L - 1)."""
    b, t, v, l = CTC["b"], CTC["t"], CTC["v"], CTC["l"]
    rng = np.random.RandomState(CTC["seed"])
    logits = (rng.randn(b, t, v) * 2).astype(np.float32)
    labels = rng.randint(1, v, (b, l))
    labels[:, 4:7] = labels[:, 4:5]
    llen, lablen = np.full(b, t), np.full(b, l)
    llen[1], lablen[1], llen[2] = t - 30, l - 5, l - 1
    labels[np.arange(l)[None, :] >= lablen[:, None]] = -1
    return logits, llen, labels, lablen


def check_ctc_loss(device="cuda") -> None:
    """The CTC loss's two kernels against the twins on the same
    log-probs."""
    logits, llen, labels, lablen = (_t(a, device) for a in ctc_inputs())
    case = "B={b} T={t} V={v} L={l}".format(**CTC)
    logp = torch.log_softmax(logits, -1)
    w = torch.linspace(0.5, 1.5, CTC["b"], device=device)
    runs = []
    for _ in range(2):
        nll, keep, alpha, beta = pcl.ctc_loss_fwd(logp, labels, llen, lablen)
        runs.append((nll, keep, pcl.ctc_loss_bwd(
            logp, alpha, beta, labels, llen, lablen, keep, w)))
    (nll, keep, grad), again = runs
    _equal("ctc_loss_fwd", case + " determinism", again[0], nll)
    _equal("ctc_loss_bwd", case + " determinism", again[2], grad)
    want = pcl.ctc_fwd_plain(logp, labels, llen, lablen)
    _equal("ctc_loss_fwd", case + " keep", keep, want[1])
    _close("ctc_loss_fwd", case + " nll", nll, want[0], CTC_TOL, 0.0)
    if nll[2].item() != 0.0:
        raise _fail("ctc_loss_fwd", case, "the infeasible sample's NLL is "
                    "not 0")
    if grad[2].any():
        raise _fail("ctc_loss_bwd", case, "the infeasible sample's "
                    "gradient is not 0")
    want_g = pcl.ctc_bwd_plain(logp, want[2], want[3], labels, llen, lablen,
                               want[1], w)
    _near_largest("ctc_loss_bwd", case + " gradient", grad, want_g, CTC_TOL)


def check_train_kernels(device="cuda") -> None:
    """The training stem tail, then flash attention with dropout at the
    JAX check's lengths, in fp32 and in bf16, then the CTC loss."""
    check_stem_fuse(True, device)
    rng = np.random.RandomState(7)
    for t in FLASH["lengths"]:
        state = rng.get_state()
        for dtype in (torch.float32, torch.bfloat16):
            rng.set_state(state)  # both types see the JAX check's draws
            check_flash(t, dtype, rng, device)
    check_ctc_loss(device)
