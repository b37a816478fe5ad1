"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``avsr_tpu_torch/csrc`` and then, on
``cuda:0``:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the kernels (one nvcc per source, all at once), with the time;
3. holds each of the six kernels against its plain PyTorch twin at the
   serving path's shapes (B=8, T=375 padded to 384, beam 3, pre-beam 4),
   with a stated limit, and times the kernel, the twin and, where one
   PyTorch call computes the same function, that call; computes each
   kernel's bound from the bytes and operations of its inputs;
4. serves the full-width flagship configuration (24x1024 AV-HuBERT encoder,
   6x1024 decoder, vocab 5049; seeded random weights) through
   ``Recognizer.transcribe_batch``, B=8 utterances of 375 frames: the
   joint CTC/attention beam at the default ``ctc_weight=0.1`` with the
   bookkeeping unfused (the default) and fused, the attention-only beam
   (``ctc_weight=0``), and greedy CTC. Each run starts with every launch
   count at 0 and is checked for the kernels of its path;
5. runs the same full-width weights through the CUDA path (bookkeeping
   fused) and the CPU path (which uses the plain twins, unfused) at
   ``ctc_weight=0.1``, in fp32 and in the serving precision, and compares
   them.

Any failure exits non-zero before the last line. The line before the last
holds the per-kernel JSON record: ``launches`` is the count from the
default beam run of phase 4 (``ctc_weight=0.1``, unfused), and for
``beam_update``, which only the fused bookkeeping runs, from the fused run.
The last line is ``{"ok": true, "device": {...}}``. Without CUDA it exits
non-zero at once.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B = 8  # serving batch of the kernel checks and the full-width run
FRAMES = 375  # 15 s at 25 fps
SEGMENT_SECONDS = 15.0
KV_CAP = 192
VOCAB = 5049
EOS = VOCAB - 1
BEAM, PRE_BEAM = 3, 4
T_PAD = 384  # FRAMES + 2 rounded up to 128, the CTC scorer's time axis

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s, and operations/s by operand type (dense tensor-core bf16, fp32
# outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
# above the H100's highest SM clock (1.98 GHz): a spin of 2x the host's
# enqueue time in these cycles lasts at least that long
SPIN_CYCLES_PER_S = 2.0e9


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 4, warmup: int = 2, repeats: int = 5) -> float:
    """Device time of one call: the median over ``repeats`` of CUDA events
    around ``iters`` calls, queued behind a spin kernel that outlasts
    their host-side enqueue. So the events time the device alone; around
    one call on an idle device they would time the host's launch
    overhead, which exceeds a small kernel's run. ``iters`` stays small:
    a twin launches ~150 kernels a call, and past about a thousand queued
    launches the host blocks and the device waits on it again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(nbytes: float, ops: float, kind: str):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the operations over the peak rate
    of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def step_state(seed: int, i: int, dev, ties: bool):
    """One beam step's bookkeeping inputs at the serving shapes (B=8, beam
    3, pre-beam 4, L=377, a 192-row ancestry), on the card. Lane 0 takes
    its forced last step, lane 1 is stopped, lane 2 has eos among its
    pre-beam ids and ends hypotheses; with ``ties`` every lane's
    hypotheses 0 and 1 are identical, so their candidates tie."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ll = FRAMES + 2

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    xlens = randint(i + 1, FRAMES + 1, B)
    xlens[0] = i + 1
    stop = torch.zeros(B, dtype=torch.bool, device=dev)
    stop[1] = True
    st = dict(
        xlens=xlens,
        dec_top=randn(B, BEAM, PRE_BEAM, scale=3.0, shift=-4.0).sort(
            dim=-1, descending=True).values,
        dec_eos=randn(B, BEAM, scale=3.0, shift=-6.0),
        psi_cand=randn(B, BEAM, PRE_BEAM, scale=10.0, shift=-30.0),
        psi_eos=randn(B, BEAM, scale=10.0, shift=-40.0),
        ctc_s=randn(B, BEAM, scale=10.0, shift=-25.0),
        part_ids=randint(1, EOS, B, BEAM, PRE_BEAM),
        score=randn(B, BEAM, scale=5.0, shift=-20.0),
        alive=torch.ones(B, BEAM, dtype=torch.bool, device=dev),
        stop=stop,
        yseq=randint(1, EOS, B, BEAM, ll),
        anc=randint(0, BEAM, KV_CAP, B, BEAM),
        ended_best=randn(B, ll, scale=5.0, shift=-30.0),
        ended_cnt=randint(0, 3, B, ll),
        best_score=randn(B, scale=5.0, shift=-15.0),
        best_yseq=randint(1, EOS, B, ll),
        best_len=randint(2, i + 3, B),
    )
    st["ended_best"][:, i:] = -1.0e30
    st["ended_cnt"][:, i:] = 0
    if ties:
        for name in ("dec_top", "part_ids", "psi_cand", "dec_eos", "score",
                     "psi_eos", "ctc_s"):
            st[name][:, 1] = st[name][:, 0]
    st["part_ids"][2, 1, 2] = EOS
    st["dec_eos"][2, 0] = 10.0
    return st


def phase_kernels(dev):
    """Each kernel vs its plain twin at the serving shapes; returns records."""
    from torch.nn import functional as F

    from avsr_tpu_torch.ops.kernels import beam_update as pbu
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa
    from avsr_tpu_torch.ops.kernels import row_gather as prg
    from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl
    from avsr_tpu_torch.ops.kernels import topk as ptk

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    records = {}

    # flash: encoder self-attention, (B*16, 384, 64) bf16, 377 valid frames
    # and shorter rows; out within 8e-3 abs (two bf16 ulps below |out| = 1:
    # the kernel keeps p in fp32 where the twin rounds it), lse within 1e-4
    n, t, d = B * 16, 384, 64
    q, k, v = (torch.randn(n, t, d, generator=g, device=dev).to(bf16)
               for _ in range(3))
    lens = torch.full((n,), 377, device=dev)
    lens[::5] = 200
    bias = torch.where(torch.arange(t, device=dev)[None] < lens[:, None],
                       0.0, -1.0e30).contiguous()
    scale = d ** -0.5
    got, lse = pfa.flash_attention_fwd(q, k, v, bias, scale)
    want, want_lse = pfa.flash_attention_plain(q, k, v, bias, scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    print(f"# flash_attention_fwd max_abs_err={err:.3e} lse_err={lse_err:.3e}")
    check(err <= 8e-3 and lse_err <= 1e-4, "flash_attention_fwd disagrees")
    mask = bias[:, None, :].to(bf16)
    records["flash_attention_fwd"] = dict(
        source="avsr_tpu_torch/csrc/flash_attention.cu",
        replaces="avsr_tpu/ops/pallas/flash_attention.py:296",
        max_abs_err=err,
        ms=cuda_ms(lambda: pfa.flash_attention_fwd(q, k, v, bias, scale)),
        plain_ms=cuda_ms(lambda: pfa.flash_attention_plain(q, k, v, bias, scale)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)),
        # q.k and p.v: 2 flops per multiply-add, bf16 operands
        bound=bound(nbytes(q, k, v, bias, got, lse), 4 * n * t * t * d,
                    "bf16"),
    )

    # decode_attention: (B*3, 1024) bf16 queries over a (B*3, 192, 2048)
    # bf16 cache, H=16; the written row bit-exact, pos >= S clamps to S-1;
    # out (|out| ~ 0.1) within 1e-3 abs: the kernel rounds q and p where
    # the twin does, so only the fp32 summation order differs
    lanes, heads, s_max, c = 3, 16, KV_CAP, 1024
    nl = B * lanes
    errs = []
    for pos in (0, 100, s_max - 1, 250):
        q = (torch.randn(nl, c, generator=g, device=dev) * 0.125).to(bf16)
        kv = torch.randn(nl, s_max, 2 * c, generator=g, device=dev).to(bf16)
        row = torch.randn(nl, 2 * c, generator=g, device=dev).to(bf16)
        anc = torch.randint(0, lanes, (s_max, B, lanes), generator=g,
                            device=dev)
        anc[min(pos, s_max - 1)] = torch.arange(lanes, device=dev)
        valid = (torch.arange(s_max, device=dev) <= pos)[:, None, None, None] & (
            anc[..., None] == torch.arange(lanes, device=dev))
        lb = torch.where(valid.permute(1, 2, 0, 3), 0.0, -1.0e30).contiguous()
        kv_plain = kv.clone()
        got, got_kv = pda.decode_attention(pos, q, kv, lb, lanes, heads, row)
        want, want_kv = pda.decode_attention_plain(pos, q, kv_plain, lb, lanes,
                                                   heads, row)
        torch.cuda.synchronize()
        check(got_kv is kv, "decode_attention did not update in place")
        check(torch.equal(got_kv, want_kv),
              f"decode_attention cache differs at pos={pos}")
        check(torch.equal(got_kv[:, min(pos, s_max - 1)], row),
              f"decode_attention row not written at pos={pos}")
        errs.append((got.float() - want.float()).abs().max().item())
    err = max(errs)
    print(f"# decode_attention max_abs_err={err:.3e} (pos 0,100,191,250)")
    check(err <= 1e-3, "decode_attention disagrees")
    # timed at pos=250: the whole 192-row cache is valid and read
    records["decode_attention"] = dict(
        source="avsr_tpu_torch/csrc/decode_attention.cu",
        replaces="avsr_tpu/ops/pallas/decode_attention.py:222",
        max_abs_err=err,
        ms=cuda_ms(lambda: pda.decode_attention(pos, q, kv, lb, lanes, heads,
                                                row)),
        plain_ms=cuda_ms(lambda: pda.decode_attention_plain(
            pos, q, kv, lb, lanes, heads, row)),
        library_ms=None,  # no one call attends and writes the row
        # the whole cache, bias, q and row read, out and the row written;
        # q.k and p.v over lanes x rows for each lane's query
        bound=bound(nbytes(q, kv, lb, row, got, row),
                    4 * nl * lanes * s_max * c, "bf16"),
    )

    # topk: pre-beam (B*3, 5049) k=4 and flat beam (B, 15) k=3, exact, with
    # ties against the row maximum
    errs = []
    for rows, vocab, kk in ((B * 3, 5049, 4), (B, 15, 3)):
        x = torch.randn(rows, vocab, generator=g, device=dev)
        x[:, vocab // 2] = x.amax(dim=1)
        x[:, -1] = x.amax(dim=1)
        x[1] = 0.5
        gv, gi = ptk.topk_lastdim(x, kk)
        wv, wi = ptk.topk_plain(x, kk)
        torch.cuda.synchronize()
        check(torch.equal(gi, wi) and torch.equal(gv, wv),
              f"topk_lastdim disagrees at ({rows}, {vocab}) k={kk}")
        errs.append((gv - wv).abs().max().item())
    x = torch.randn(B * 3, 5049, generator=g, device=dev)
    print(f"# topk_lastdim exact (max_abs_err={max(errs)})")
    vals, ids = ptk.topk_lastdim(x, 4)
    records["topk_lastdim"] = dict(
        source="avsr_tpu_torch/csrc/topk.cu",
        replaces="avsr_tpu/ops/pallas/topk.py:47",
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: ptk.topk_lastdim(x, 4)),
        plain_ms=cuda_ms(lambda: ptk.topk_plain(x, 4)),
        library_ms=cuda_ms(lambda: torch.topk(x, 4)),
        # one comparison per element and round
        bound=bound(nbytes(x, vals, ids), 4 * x.numel(), "fp32"),
    )

    # cumlogsumexp: the scorer's (T, B*K*S') = (384, 96) scans, columns
    # drifting 8.5 nats a frame (as the CTC terms do), -inf prefixes, an
    # all -inf column. The kernel sums in sequential order, the twin as a
    # tree of depth 9: each of the 384 rescale-and-add steps rounds the
    # running sum by a few ulps, so log s may move by ~384 x 2 x 6e-8 =
    # 4.6e-5; limit 1e-4 + 1e-6 |x| (the output's own rounding at |x| up
    # to ~3300), and -inf exactly where the twin has it
    cols = B * BEAM * PRE_BEAM
    x = torch.randn(T_PAD, cols, generator=g, device=dev) * 3.0
    x = x - 8.5 * torch.arange(T_PAD, device=dev).flip(0)[:, None]
    x[: T_PAD // 2, : cols // 4] = float("-inf")
    x[:, -1] = float("-inf")
    got = psl.cumlogsumexp(x)
    want = psl.cumlogsumexp_plain(x)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    diff = (got - want).abs()[fin]
    err = diff.max().item()
    print(f"# cumlogsumexp max_abs_err={err:.3e} (384, 96)")
    check(torch.equal(torch.isneginf(got), torch.isneginf(want))
          and not torch.isnan(got).any().item()
          and bool((diff <= 1e-4 + 1e-6 * want[fin].abs()).all()),
          "cumlogsumexp disagrees")
    records["cumlogsumexp"] = dict(
        source="avsr_tpu_torch/csrc/scan_logsumexp.cu",
        replaces="avsr_tpu/ops/pallas/scan_logsumexp.py:27",
        max_abs_err=err,
        ms=cuda_ms(lambda: psl.cumlogsumexp(x)),
        plain_ms=cuda_ms(lambda: psl.cumlogsumexp_plain(x)),
        library_ms=cuda_ms(lambda: torch.logcumsumexp(x, 0)),
        # per element: max, two subtractions, two exp, a multiply-add, log
        bound=bound(nbytes(x, got), 8 * x.numel(), "fp32"),
    )

    # row_gather: the B*K*S' = 96 candidate rows of the (B*V, 384)
    # transposed log-prob table; bit-exact
    src = torch.randn(B * VOCAB, T_PAD, generator=g, device=dev)
    idx = (torch.randint(0, VOCAB, (B, BEAM, PRE_BEAM), generator=g,
                         device=dev)
           + VOCAB * torch.arange(B, device=dev)[:, None, None]).view(-1)
    got = prg.row_gather(src, idx)
    want = prg.row_gather_plain(src, idx)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "row_gather disagrees")
    print("# row_gather exact (96 rows of (40392, 384))")
    records["row_gather"] = dict(
        source="avsr_tpu_torch/csrc/row_gather.cu",
        replaces="avsr_tpu/ops/pallas/row_gather.py:43",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: prg.row_gather(src, idx)),
        plain_ms=cuda_ms(lambda: prg.row_gather_plain(src, idx)),
        library_ms=cuda_ms(lambda: torch.index_select(src, 0, idx)),
        # the rows asked for, not the table: read once, written once
        bound=bound(nbytes(idx, got, got), 0, "fp32"),
    )

    # beam_update: step states with and without ties, mid-utterance and
    # at the forced last step of every lane; every output bit-exact
    kw = dict(w_dec=0.9, w_ctc=0.1, eos=EOS, neg=-1.0e30, d_end=-10.0,
              m_end=3)
    for seed, i, ties in ((1, 40, False), (2, 40, True), (3, 200, True),
                          (4, FRAMES - 1, False)):
        st = step_state(seed, i, dev, ties)
        if i == FRAMES - 1:
            st["xlens"][:] = FRAMES  # every lane takes its forced step
        got = pbu.beam_update(i, *st.values(), **kw)
        want = pbu.beam_update_plain(i, *st.values(), **kw)
        torch.cuda.synchronize()
        for name, w in want.items():
            check(torch.equal(got[name], w),
                  f"beam_update {name} differs at step {i}, ties={ties}")
    print("# beam_update exact (4 step states: ties, forced last step)")
    st = step_state(5, 200, dev, True)
    out = pbu.beam_update(200, *st.values(), **kw)
    records["beam_update"] = dict(
        source="avsr_tpu_torch/csrc/beam_update.cu",
        replaces="avsr_tpu/ops/pallas/beam_update.py:35",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: pbu.beam_update(200, *st.values(), **kw)),
        plain_ms=cuda_ms(lambda: pbu.beam_update_plain(200, *st.values(),
                                                       **kw)),
        library_ms=None,  # no one call does the step's bookkeeping
        # weighting (5 flops a candidate) and k rounds over the candidates
        bound=bound(nbytes(*st.values(), *out.values()),
                    B * BEAM * (PRE_BEAM + 1) * (5 + BEAM), "fp32"),
    )
    for name, r in records.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"# {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")
    return records


def flagship_config(dtype: str):
    """The flagship configuration with the serving switches on."""
    from avsr_tpu_torch.core.config import AVHubertAVSRConfig

    cfg = AVHubertAVSRConfig(decoder_cache_dtype=dtype,
                             decoder_param_dtype=dtype,
                             decode_fused_attention=True)
    cfg.encoder.use_flash_attention = True
    return cfg


def phase_serving(dev, gpu_name: str):
    """Full-width bf16 serving of B=8 15 s utterances, one run per path,
    each with every launch count set to 0 just before it; returns the
    counts of each run."""
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.data.synthetic import synthetic_batch
    from avsr_tpu_torch.decode.recognizer import Recognizer
    from avsr_tpu_torch.models.e2e import AVSRModel
    from avsr_tpu_torch.ops.kernels import beam_update as pbu
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa
    from avsr_tpu_torch.ops.kernels import row_gather as prg
    from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl
    from avsr_tpu_torch.ops.kernels import topk as ptk

    cfg = flagship_config("bfloat16")
    with torch.device(dev):
        model = AVSRModel(cfg)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    rec = Recognizer(model=model, cfg=cfg, device=dev,
                     t_buckets=(FRAMES + 2,), max_decode_tokens=KV_CAP,
                     encode_dtype="bfloat16", video_wire="delta2")
    check(rec.ctc_weight == 0.1 and not rec.fused_bookkeeping,
          "the Recognizer's defaults changed")
    audio, video = synthetic_batch(np.random.RandomState(0), [FRAMES] * B)
    counters = (pfa.flash_attention_fwd, pda.decode_attention,
                ptk.topk_lastdim, prg.row_gather, psl.cumlogsumexp,
                pbu.beam_update)
    layers = cfg.encoder.num_hidden_layers
    audio_s = B * SEGMENT_SECONDS

    def serve(name, mode, ctc_weight, fused):
        rec.ctc_weight, rec.fused_bookkeeping = ctc_weight, fused
        rec.transcribe_batch(audio, video, mode=mode)  # warm-up
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        out = rec.transcribe_batch(audio, video, mode=mode)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        check(len(out) == B, f"{name}: wrong number of transcripts")
        for toks in out:
            check(toks.ndim == 1 and ((toks >= 0) & (toks < cfg.odim)).all(),
                  f"{name}: token ids out of range")
        print(f"# {name}: transcribe_batch {1e3 * wall:.1f} ms -> "
              f"{audio_s / wall:.1f} audio-s/s; launches {launches}")
        check(launches["flash_attention_fwd"] >= layers,
              f"{name}: flash_attention_fwd not launched once per layer")
        return launches

    runs = {}
    for name, ctc_weight, fused in (("beam ctc_weight=0.1", 0.1, False),
                                    ("beam ctc_weight=0.1 fused", 0.1, True),
                                    ("beam ctc_weight=0", 0.0, False)):
        n = runs[name] = serve(name, "beam", ctc_weight, fused)
        steps = n["decode_attention"] // cfg.dlayers
        check(steps >= 1 and n["decode_attention"] == steps * cfg.dlayers,
              f"{name}: decode_attention not launched per layer and step")
        check(n["topk_lastdim"] >= (1 if fused else 2) * steps,
              f"{name}: topk_lastdim not launched every step")
        if ctc_weight:
            check(n["row_gather"] >= steps,
                  f"{name}: row_gather not launched every step")
            check(n["cumlogsumexp"] >= 2 * steps,
                  f"{name}: cumlogsumexp not launched twice a step")
        check((n["beam_update"] >= steps) if fused
              else n["beam_update"] == 0,
              f"{name}: beam_update launches {n['beam_update']}")
    runs["greedy"] = serve("greedy", "greedy", 0.1, False)

    # stage times (device-synchronised host clock) at the defaults
    rec.ctc_weight, rec.fused_bookkeeping = 0.1, False
    aud, vid, lens, _ = rec._pad_batch(audio, video)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    feats, ctc = rec.encode(aud, vid, lens)
    torch.cuda.synchronize()
    s1 = time.perf_counter()
    yseqs, ylens, scores = rec.beam(feats, ctc, lens)
    torch.cuda.synchronize()
    s2 = time.perf_counter()
    rec.fused_bookkeeping = True
    fy, fl, fs = rec.beam(feats, ctc, lens)
    torch.cuda.synchronize()
    s3 = time.perf_counter()
    check(torch.isfinite(ctc).all().item() and tuple(ctc.shape) ==
          (B, FRAMES + 2, cfg.odim), "CTC log-probs malformed")
    check(torch.isfinite(scores).all().item(), "beam scores not finite")
    check(torch.equal(yseqs, fy) and torch.equal(ylens, fl)
          and torch.equal(scores, fs),
          "fused bookkeeping differs from unfused on the card")
    print(f"# {gpu_name}: encode {1e3 * (s1 - s0):.1f} ms, beam "
          f"ctc_weight=0.1 {1e3 * (s2 - s1):.1f} ms unfused, "
          f"{1e3 * (s3 - s2):.1f} ms fused (bit-identical; longest "
          f"hypothesis {int(ylens.max().item())} tokens with sos/eos; "
          f"B={B}, T={FRAMES})")
    return runs


def phase_parity(dev):
    """Full width, B=2, T=64, joint CTC/attention beam at ctc_weight=0.1:
    the CUDA path with its bookkeeping fused (beam_update) vs the CPU path
    (the plain twins, unfused), in fp32 and at the serving precision (bf16
    encode, bf16 decoder weights and K|V cache)."""
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.data.synthetic import synthetic_batch
    from avsr_tpu_torch.decode.recognizer import Recognizer
    from avsr_tpu_torch.models.e2e import AVSRModel

    audio, video = synthetic_batch(np.random.RandomState(1), (64, 50))
    # (dtype, CTC log-prob abs bound, beam-score relative bound). bf16
    # rounds in different places on the two sides (cuDNN vs oneDNN, the
    # flash kernel's unrounded p), 6.2e-2 and 5.0e-3 measured on an H100;
    # random weights leave argmax margins below that, so bf16 tokens may
    # differ and are reported, not required (the CPU tests hold the bf16
    # port token-exact against the JAX package)
    ctc_fp32 = None
    for dtype, ctc_tol, score_tol in (("float32", 1e-3, 1e-4),
                                      ("bfloat16", 0.2, 2e-2)):
        cfg = flagship_config(dtype)
        cpu_model = AVSRModel(cfg)
        init_weights(cpu_model, torch.Generator().manual_seed(1))
        kw = dict(cfg=cfg, ctc_weight=0.1, t_buckets=(64,),
                  max_decode_tokens=KV_CAP, encode_dtype=dtype,
                  video_wire="delta2")
        recs = {"cuda": Recognizer(model=copy.deepcopy(cpu_model),
                                   device=dev, fused_bookkeeping=True, **kw),
                "cpu": Recognizer(model=cpu_model, device="cpu", **kw)}
        out = {}
        for name, rec in recs.items():
            aud, vid, ln, _ = rec._pad_batch(audio, video)
            feats, ctc = rec.encode(aud, vid, ln)
            yseq, ylen, score = rec.beam(feats, ctc, ln)
            out[name] = dict(
                ctc=ctc.cpu(), yseq=yseq.cpu(), ylen=ylen.cpu(),
                score=score.cpu(),
                greedy=rec.transcribe_batch(audio, video, mode="greedy"))
        cu, cp = out["cuda"], out["cpu"]
        err = (cu["ctc"] - cp["ctc"]).abs().max().item()
        score_err = ((cu["score"] - cp["score"]).abs()
                     / cp["score"].abs()).max().item()
        same_beam = (torch.equal(cu["ylen"], cp["ylen"])
                     and torch.equal(cu["yseq"], cp["yseq"]))
        same_greedy = all(np.array_equal(a, b)
                          for a, b in zip(cu["greedy"], cp["greedy"]))
        if ctc_fp32 is None:
            ctc_fp32 = cu["ctc"]
        gap = (cu["ctc"] - ctc_fp32).abs().max().item()
        print(f"# slice parity cuda (fused) vs cpu (unfused), "
              f"ctc_weight=0.1 ({dtype}, B=2, T=64): ctc "
              f"max_abs_err={err:.3e} (limit {ctc_tol:g}; {dtype} vs "
              f"float32 on cuda {gap:.3e}); beam score "
              f"rel_err={score_err:.3e} (limit {score_tol:g}); beam tokens "
              f"equal={same_beam} (lengths {cu['ylen'].tolist()}); greedy "
              f"tokens equal={same_greedy}")
        check(err <= ctc_tol, f"{dtype} CTC log-probs: cuda vs cpu")
        check(score_err <= score_tol, f"{dtype} beam scores: cuda vs cpu")
        if dtype == "float32":
            check(same_beam and same_greedy, "fp32 tokens: cuda vs cpu")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gpu_name = torch.cuda.get_device_name(0)
    print(f"# phase 1: {gpu_name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    print(smi)

    from avsr_tpu_torch.ops.kernels import _build

    path, seconds = _build.build()
    _build.library()
    log = path.with_suffix(".log")
    print(f"# phase 2: kernels built in {seconds:.1f} s -> {path.name}")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   ptxas {line.strip()}")

    print("# phase 3: kernels vs plain twins at the serving shapes")
    records = phase_kernels(dev)
    print("# phase 4: full-width serving, bf16, B=8, 375 frames")
    runs = phase_serving(dev, smi)
    print("# phase 5: full-width slice parity, cuda vs cpu")
    phase_parity(dev)
    print(f"# all phases passed in {time.perf_counter() - t_start:.1f} s")

    main_path = runs["beam ctc_weight=0.1"]
    main_path["beam_update"] = runs["beam ctc_weight=0.1 fused"]["beam_update"]
    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=main_path[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"])
               for name, r in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
