"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``avsr_tpu_torch/csrc`` and then, on
``cuda:0``:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the kernels, with the build time;
3. holds each kernel against its plain PyTorch twin at the serving path's
   shapes (B=8) and times both;
4. serves the full-width flagship configuration (24x1024 AV-HuBERT encoder,
   6x1024 decoder, vocab 5049; seeded random weights) through
   ``Recognizer.transcribe_batch`` in beam and greedy mode, B=8 utterances
   of 375 frames, counting the launches of every kernel;
5. runs the same full-width weights through the CUDA path and the CPU path
   (which uses the plain twins), in fp32 and in the serving precision, and
   compares them.

Any failure exits non-zero before the last line. The line before the last
holds the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero at once.
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


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(dev):
    """Each kernel vs its plain twin at the serving shapes; returns records."""
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa
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
    records["flash_attention_fwd"] = dict(
        source="avsr_tpu_torch/csrc/flash_attention.cu",
        replaces="avsr_tpu/ops/pallas/flash_attention.py:296",
        max_abs_err=err,
        ms=cuda_ms(lambda: pfa.flash_attention_fwd(q, k, v, bias, scale)),
        plain_ms=cuda_ms(lambda: pfa.flash_attention_plain(q, k, v, bias, scale)),
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
    records["topk_lastdim"] = dict(
        source="avsr_tpu_torch/csrc/topk.cu",
        replaces="avsr_tpu/ops/pallas/topk.py:47",
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: ptk.topk_lastdim(x, 4)),
        plain_ms=cuda_ms(lambda: ptk.topk_plain(x, 4)),
    )
    for name, r in records.items():
        print(f"# {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return records


def flagship_config(dtype: str):
    """The flagship configuration with the serving switches on."""
    from avsr_tpu.core.config import AVHubertAVSRConfig

    cfg = AVHubertAVSRConfig(decoder_cache_dtype=dtype,
                             decoder_param_dtype=dtype,
                             decode_fused_attention=True)
    cfg.encoder.use_flash_attention = True
    return cfg


def phase_serving(dev, gpu_name: str):
    """Full-width bf16 serving of B=8 15 s utterances; returns launches."""
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.data.synthetic import synthetic_batch
    from avsr_tpu_torch.decode.recognizer import Recognizer
    from avsr_tpu_torch.models.e2e import AVSRModel
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa
    from avsr_tpu_torch.ops.kernels import topk as ptk

    cfg = flagship_config("bfloat16")
    with torch.device(dev):
        model = AVSRModel(cfg)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    rec = Recognizer(model=model, cfg=cfg, device=dev, ctc_weight=0.0,
                     t_buckets=(FRAMES + 2,), max_decode_tokens=KV_CAP,
                     encode_dtype="bfloat16", video_wire="delta2")
    audio, video = synthetic_batch(np.random.RandomState(0), [FRAMES] * B)
    rec.transcribe_batch(audio, video, mode="beam")  # warm-up
    torch.cuda.synchronize()

    counters = (pfa.flash_attention_fwd, pda.decode_attention, ptk.topk_lastdim)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    beam_out = rec.transcribe_batch(audio, video, mode="beam")
    t1 = time.perf_counter()
    greedy_out = rec.transcribe_batch(audio, video, mode="greedy")
    t2 = time.perf_counter()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"# launches in one beam + one greedy batch: {launches}")
    check(launches["flash_attention_fwd"] >= 2 * cfg.encoder.num_hidden_layers,
          "flash_attention_fwd not launched once per encoder layer")
    check(launches["decode_attention"] >= cfg.dlayers,
          "decode_attention not launched by the decoder")
    check(launches["topk_lastdim"] >= 2, "topk_lastdim not launched by the beam")
    for out in (beam_out, greedy_out):
        check(len(out) == B, "wrong number of transcripts")
        for toks in out:
            check(toks.ndim == 1 and ((toks >= 0) & (toks < cfg.odim)).all(),
                  "token ids out of range")

    # stage times (device-synchronised host clock)
    aud, vid, lens, _ = rec._pad_batch(audio, video)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    feats, ctc = rec.encode(aud, vid, lens)
    torch.cuda.synchronize()
    s1 = time.perf_counter()
    yseqs, ylens, _ = rec.beam(feats, lens)
    torch.cuda.synchronize()
    s2 = time.perf_counter()
    check(torch.isfinite(ctc).all().item() and tuple(ctc.shape) ==
          (B, FRAMES + 2, cfg.odim), "CTC log-probs malformed")
    longest = int(ylens.max().item())
    audio_s = B * SEGMENT_SECONDS
    print(f"# {gpu_name}: encode {1e3 * (s1 - s0):.1f} ms, beam "
          f"{1e3 * (s2 - s1):.1f} ms (longest hypothesis {longest} tokens "
          f"with sos/eos), transcribe_batch "
          f"beam {1e3 * (t1 - t0):.1f} ms -> {audio_s / (t1 - t0):.1f} "
          f"audio-s/s; greedy {1e3 * (t2 - t1):.1f} ms -> "
          f"{audio_s / (t2 - t1):.1f} audio-s/s (B={B}, T={FRAMES})")
    return launches


def phase_parity(dev):
    """Full width, B=2, T=64: the CUDA path vs the CPU path (which runs the
    plain twins), in fp32 and at the serving precision (bf16 encode, bf16
    decoder weights and K|V cache)."""
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
        kw = dict(cfg=cfg, ctc_weight=0.0, t_buckets=(64,),
                  max_decode_tokens=KV_CAP, encode_dtype=dtype,
                  video_wire="delta2")
        recs = {"cuda": Recognizer(model=copy.deepcopy(cpu_model),
                                   device=dev, **kw),
                "cpu": Recognizer(model=cpu_model, device="cpu", **kw)}
        out = {}
        for name, rec in recs.items():
            aud, vid, ln, _ = rec._pad_batch(audio, video)
            feats, ctc = rec.encode(aud, vid, ln)
            yseq, ylen, score = rec.beam(feats, ln)
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
        print(f"# slice parity cuda vs cpu ({dtype}, B=2, T=64): ctc "
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
    launches = phase_serving(dev, smi)
    print("# phase 5: full-width slice parity, cuda vs cpu")
    phase_parity(dev)
    print(f"# all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"])
               for name, r in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
