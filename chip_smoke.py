"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``avsr_tpu_torch/csrc`` and then, on
``cuda:0``:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the kernels (one nvcc per source, all at once), with the time;
3. holds each of the thirteen kernels, and the pre-beam top-k that
   gathers the CTC candidate rows in its launch (``topk_gather_rows``),
   against its plain PyTorch twin, with
   a stated limit, and times the kernel, the twin and, where one PyTorch
   call computes the same function, that call; computes each kernel's
   bound from the bytes and operations of its inputs. The serving kernels
   at the serving path's shapes (B=8, T=375 padded to 384, beam 3,
   pre-beam 4); the flash forward with dropout and the two backward
   kernels at the training shapes (N = 6*16 heads, T=384, D=64, bf16 and
   fp32, ragged key bias), the forward's dropout mask read out and held
   bit for bit against the twin's, two backward calls held bit for bit
   against each other, the bf16 forward's share of outputs bit-equal to
   the twin's printed, and the cost of the dropout draw (each kernel
   timed without it); the flash kernels' library call is PyTorch's fused
   SDPA as a user calls it (4-D (B, H, T, D), the key bias as a (B, 1, 1,
   T) mask, ``dropout_p`` at the kernels' rate, forward and backward),
   each backend of ``SDPA_BACKENDS`` forced in turn with ``sdpa_kernel``
   and the fastest kept, its name printed; ``decode_attention`` checked at
   B=8 and B=32 at pos 0, 100, 191 and 250 (bf16 and unrounded outputs
   within ``output_bound`` of the twin's, ROADMAP C27) and timed at pos 250
   warm (one
   cache) and cold (rotating over the six decoder layers' caches, which
   the L2 cannot hold; the record's time), with fused SDPA on strided
   views of the cache as its library call (and the row write's own copy
   time printed beside it); ``topk_lastdim`` at the beam's two shapes,
   the pre-beam (B*3, 5049) k=4 and the flat (B, 15) k=3, at B=8 (the
   records ``topk_lastdim`` and ``topk_lastdim_flat``) and B=32, exact
   against the twin on rows with ties, equal values, too few finite
   entries and starts off a 16-byte boundary, each timed beside
   ``torch.topk``; ``row_gather``, exact; ``topk_gather_rows`` at B=8
   (24, 5049) k=4 with the (B*V, 384) table (the record) and beam 22's
   (704, 5049) k=33 with a (B*V, 128) one, ids and rows exact, one launch
   each, timed beside the pair the beam launched before (the top-k, the
   index add, ``row_gather``); ``beam_update`` at B=8 (the record) and B=32, every
   output bit for bit, timed beside the launch floor (a kernel that spins
   one cycle); ``cumlogsumexp`` at (384, 96) (B=8, the
   record) and (384, 384) (B=32) against ``torch.logcumsumexp``; the
   fused stem tail's four kernels at the training shape (N = 6*384
   channels-last frames of (64, 44, 44), bf16), plus fp32 and tied-maxima
   cases and the eval apply at the serving shape (N = 8*377), the apply's
   output held bit for bit against the twin given the same statistics and
   bwd1's dz against its twin as well as dx, with
   torch's own BatchNorm passes
   (``batch_norm_stats``, ``batch_norm_backward_elemt``) as the library
   calls of stats and bwd2; the one-launch decoder layer at the serving
   widths (C=1024, a 192-row cache, 377 source rows) at B=8 and B=32 (24
   and 96 lanes, one launch each) at pos 0, 100, 191 and 250, two calls
   bit-equal, timed at pos 250 warm and cold (rotating over six layers'
   weights and caches; the record's time) beside the unfused layer step;
   and at 22 lanes, B=32 (704 lanes, phase 8's fused beam of 22: a 128-row
   cache, 98 source rows) at pos 0, 37, 74 and 130, checked the same way
   and timed at pos 74;
   as information, the eager composition the stem kernels replace, and
   ``bn_prelu_pool`` on channels-last and on NCHW x; the paths that beams
   above the fast kernels' limits take (ROADMAP C28), each exact against
   its twin at B=8 and at the shapes phase 8 gives them (B=32, a 128-row
   cache, L=98), and timed at phase 8's and at B=8: ``decode_attention``
   at 22 lanes (records ``decode_attention_wide``, cold at pos 74, SDPA
   beside it, at B=32 and B=8, and at B=8 over the serving cache),
   ``topk_lastdim`` at beam 22's pre-beam (B*22, 5049) k=33
   (``topk_lastdim_wide``, the radix select; ``torch.topk`` beside it) and
   its flat (B, 22*34) k=22, ``beam_update`` at K=10, S'=15 and K=22,
   S'=33 (``beam_update_wide``);
4. serves the full-width flagship configuration (24x1024 AV-HuBERT encoder,
   6x1024 decoder, vocab 5049; seeded random weights) through
   ``Recognizer.transcribe_batch``, B=8 utterances of 375 frames: the
   joint CTC/attention beam at the default ``ctc_weight=0.1`` with the
   bookkeeping unfused (the default) and fused, the attention-only beam
   (``ctc_weight=0``), and greedy CTC; then the same weights with
   ``decode_fused_layer`` and ``AVSR_FUSED_STEM_EVAL=1``. Each run starts
   with every launch count at 0 and is checked for the kernels of its
   path (with CTC one ``topk_gather_rows`` a step and no ``row_gather``;
   with the switches off, no fused-path kernel runs; with them on,
   the stem hands the fused tail channels-last frames, so nothing is
   copied);
5. runs the same full-width weights through the CUDA path (bookkeeping
   fused) and the CPU path (which uses the plain twins, unfused) at
   ``ctc_weight=0.1``, in fp32, in the serving precision, and in fp32 with
   the fused layer and stem, and compares them;
6. trains the full-width flagship through ``avsr_tpu_torch.tools.
   bench_train`` at its defaults (B=6, T=384, L=48, bf16 compute over fp32
   masters, the config's dropouts, attention dropout 0.1 in the kernels):
   2 warm-up steps and 5 timed ones, launch counts set to 0 just before
   the timed steps and read just after (24 a step for each of the three
   flash kernels, no plain twin called), finite loss and gradient norm,
   parameters changed; prints s/step, samples/s, MFU and peak memory;
   then again with ``AVSR_FUSED_STEM=1`` (each stem kernel once a step);
7. takes one fp32 ``train_step`` of the same full-width weights on the
   card (kernels) and on the CPU (twins), B=2, T=32 with one utterance
   shorter, dropout off, TF32 off, and compares the losses, the gradient
   norm and the per-module gradient norms; then again with
   ``AVSR_FUSED_STEM=1`` on both sides;
8. runs the evaluation entry point, ``avsr_tpu_torch.cli.evaluation``'s
   ``InferenceEngine`` at the CLI's defaults, on the flagship config loaded
   from a reference-format directory of seed-0 weights, with a toy
   tokenizer (``phase_eval``): 32 utterances of 2-15 s as mp4 + wav bytes
   (cv2 writes them; the phase fails without it) through ``eval_lrs2``,
   one warm pass and three timed ones, the transcripts held to
   ``Recognizer.transcribe_batch`` on the same collated features; prints
   the median wall audio-s/s (media decode, fbank and collation included)
   and the fbank route; then beams of 22 and 10, unfused and fused, on two
   3 s utterances, fused equal to unfused, and the same runs again with
   every call of the beam's top-k, bookkeeping and decode attention held
   against its twin at the shapes the engine gives them (B=32); then the
   same beams a third way, with the decoder's fused layer
   (``decode_fused_layer``), every ``decoder_layer_step`` call held
   against its twin and its launches checked (once a layer and step);
9. runs the training entry point, ``avsr_tpu_torch.cli.train.main``, on
   the flagship config loaded from a reference-format directory of seed-0
   weights with the toy tokenizer (``phase_train_cli``): 6 fine-tuning
   steps at the JAX CLI's batch defaults (2 micro-batches of 6 synthetic
   clips, an eval and a save every 3 steps, keep 1; the flash kernels'
   launches 24 a micro-batch, no twin called, only ``checkpoints/6``
   left, ``best.json`` written; the loop's wall samples/s and peak
   memory), a resume from step 6 to 8, remat at B=6, T=384 (``none``
   twice, ``full``, ``full`` with the frontend's: losses and BN
   statistics bit-equal, gradients within twice the card's run-to-run
   floor, ``full`` below ``none`` in memory), ``--pretrain`` for 3 steps
   (its five metrics), ``AVSR_FUSED_STEM=1`` for 2 steps (the stem
   kernels' launches) and the host syncs of steps 3-5 between two log
   steps, none of them from the loop's code;
10. runs the eval CLI's auto_avsr path (``phase_auto_avsr``): the
   full-width ``ConformerAVSR()`` (two 12x768 conformer encoders, an
   8192-wide fusion head, a 6x768 decoder, vocab 5049) of seed-0 weights,
   saved as a reference-format .pth and loaded through
   ``InferenceEngine(model_type="auto_avsr")``; ``eval_lrs2`` on 8 mp4 +
   wav utterances of 2-15 s (a warm pass and a timed one; wall audio-s/s),
   the encode and beam ms of a B=8 batch of 15 s utterances and the peak
   memory; two short utterances through the card (kernels) and the CPU
   (twins) in fp32, unfused, with fused bookkeeping (bit-equal to unfused
   on the card) and with the decoder's fused layer: tokens equal,
   features, CTC log-probs and scores within phase 5's limits; every card
   run's launches of B2, B3, B5 (with B4's rows), B8 and B9 counted, no
   twin called; then B2 and B9 checked and timed at the conformer
   decoder's widths (C=768, 12 heads, fp32), B9 also at C=768 in bf16 and
   C=1024 in fp32.

Any failure exits non-zero before the last line. The line before the last
holds the per-kernel JSON record: ``launches`` is the count from the run of
the kernel's main path: the default beam run of phase 4 (``ctc_weight=0.1``,
unfused) for the serving kernels (top-k's vocabulary-row and flat launches
apart; ``row_gather`` 0, since the beam gathers the CTC rows in its
pre-beam top-k's launch, ``topk_gather_rows``, whose launches count in
``topk_lastdim``'s too), the fused run for ``beam_update``, which
only the fused bookkeeping runs, the fused-layer run for
``decoder_layer_step``, phase 6's timed steps for the three flash kernels
and its ``AVSR_FUSED_STEM=1`` run's for the four stem kernels, phase 8's
beam of 22 for the wide paths (unfused for ``decode_attention_wide`` and
``topk_lastdim_wide``, fused for ``beam_update_wide``), whose
``max_abs_err`` also covers phase 8's checked beams (and
``decoder_layer_step``'s its fused-layer beams). The last
line is ``{"ok": true, "device": {...}}``. Without
CUDA it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
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
TRAIN_BATCH = 6  # bench_train's default batch
TRAIN_HEADS = TRAIN_BATCH * 16  # the encoder's attention rows in training
LAYERS = 6  # the decoder's layers: the caches a beam step reads in turn
EVAL_B = 32  # the CLI's batch_size, to which phase 8's beams pad
EVAL_T = 96  # the frame bucket of phase 8's 3 s (75-frame) utterances
EVAL_KV = 128  # their K|V cache rows: EVAL_T + 2 rounded up to 64
EVAL_POS = 74  # the last step of a 75-frame utterance

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s, and operations/s by operand type (dense tensor-core bf16, fp32
# outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
# PyTorch's fused attention backends tried as the flash kernels' yardstick
SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
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


def fastest_sdpa_ms(make, what: str, shape: str):
    """(device ms, backend) of the fastest backend of ``SDPA_BACKENDS``:
    for each, ``make(backend)`` gives the call, which forces the backend
    with ``sdpa_kernel`` (a backend that refuses raises RuntimeError), run
    once and timed by ``cuda_ms``. Every backend's time is printed."""
    from torch.nn.attention import SDPBackend

    best = None
    for name in SDPA_BACKENDS:
        try:
            fn = make(getattr(SDPBackend, name))
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"# SDPA {name} {what} refused: "
                  f"{str(e).splitlines()[0][:160]}")
            continue
        ms = cuda_ms(fn)
        print(f"# SDPA {name} {what} ({shape}): {ms:.4f} ms")
        if best is None or ms < best[0]:
            best = (ms, name)
    check(best is not None, f"no fused SDPA backend takes the {what}")
    return best


def fused_sdpa_ms(q, k, v, bias, heads: int, scale: float, rate: float,
                  do=None):
    """(device ms, backend) of PyTorch's fused SDPA on the flash kernels'
    inputs as a user calls it: the (N, T, D) rows seen as 4-D (B, H, T, D),
    the per-utterance key bias as a broadcast (B, 1, 1, T) additive mask
    in the operands' dtype, ``dropout_p`` = ``rate``. The forward, or with
    ``do`` the backward of all three gradients. Each backend of
    ``SDPA_BACKENDS`` is forced in turn with ``sdpa_kernel``; the fastest
    that takes the call is kept and every one is printed."""
    from torch.nn import functional as F
    from torch.nn.attention import sdpa_kernel

    n, t, d = q.shape
    b = n // heads
    q4, k4, v4 = (x.view(b, heads, t, d) for x in (q, k, v))
    rows = bias.view(b, heads, t)
    check(torch.equal(rows, rows[:, :1].expand_as(rows)),
          "the key bias must be one row per utterance")
    mask = rows[:, :1, None, :].to(q.dtype)

    def make(backend):
        def fwd(x=(q4, k4, v4)):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    *x, attn_mask=mask, dropout_p=rate, scale=scale)

        if do is None:
            return fwd
        leaves = [x.detach().clone().requires_grad_() for x in (q4, k4, v4)]
        out = fwd(leaves)
        g4 = do.view(b, heads, t, d)
        return lambda: torch.autograd.grad(out, leaves, g4,
                                           retain_graph=True)

    return fastest_sdpa_ms(
        make, "forward" if do is None else "backward",
        f"B={b}, H={heads}, T={t}, D={d}, {str(q.dtype)[6:]}, "
        f"dropout_p={rate}")


def bound(nbytes: float, ops: float, kind: str):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the operations over the peak rate
    of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


# beam_update's constants in the beam: the decoder's and the CTC weight at
# ctc_weight=0.1, the dead-lane score, end detection's threshold and window
BEAM_UPDATE_KW = dict(w_dec=0.9, w_ctc=0.1, eos=EOS, neg=-1.0e30,
                      d_end=-10.0, m_end=3)


def step_state(seed: int, i: int, dev, ties: bool, b: int = B, k: int = BEAM,
               sp: int = PRE_BEAM, t: int = FRAMES, kv_cap: int = KV_CAP):
    """One beam step's bookkeeping inputs at the serving shapes (b
    utterances, beam k (3), pre-beam sp (4), t=375 encoder frames so
    L=t+2=377, a kv_cap=192-row ancestry), on the card. Lane 0 takes its forced last step, lane 1 is stopped, lane 2
    has eos among its pre-beam ids and ends hypotheses; with ``ties`` every
    lane's hypotheses 0 and 1 are identical, so their candidates tie."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ll = t + 2

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    xlens = randint(i + 1, t + 1, b)
    xlens[0] = i + 1
    stop = torch.zeros(b, dtype=torch.bool, device=dev)
    stop[1] = True
    st = dict(
        xlens=xlens,
        dec_top=randn(b, k, sp, scale=3.0, shift=-4.0).sort(
            dim=-1, descending=True).values,
        dec_eos=randn(b, k, scale=3.0, shift=-6.0),
        psi_cand=randn(b, k, sp, scale=10.0, shift=-30.0),
        psi_eos=randn(b, k, scale=10.0, shift=-40.0),
        ctc_s=randn(b, k, scale=10.0, shift=-25.0),
        part_ids=randint(1, EOS, b, k, sp),
        score=randn(b, k, scale=5.0, shift=-20.0),
        alive=torch.ones(b, k, dtype=torch.bool, device=dev),
        stop=stop,
        yseq=randint(1, EOS, b, k, ll),
        anc=randint(0, k, kv_cap, b, k),
        ended_best=randn(b, ll, scale=5.0, shift=-30.0),
        ended_cnt=randint(0, 3, b, ll),
        best_score=randn(b, scale=5.0, shift=-15.0),
        best_yseq=randint(1, EOS, b, ll),
        best_len=randint(2, i + 3, b),
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


def decode_case(g, dev, b: int, pos: int, caches: int = 1,
                lanes: int = BEAM, kv_cap: int = KV_CAP, c: int = 1024,
                dtype=torch.bfloat16):
    """One ``decode_attention`` step's inputs at the serving widths: (b*K,
    c=1024) bf16 queries scaled as dh**-0.5 does (dh = 64), ``caches``
    distinct (b*K, S, 2c) bf16 K|V caches (S = ``kv_cap``, 192), the
    step's row, and a random ancestry's lane bias (B, K, S, J) with each
    lane its own ancestor at the step; K = ``lanes`` (the beam, 3). The
    conformer's decoder: c=768 and fp32."""
    nl = b * lanes
    q = (torch.randn(nl, c, generator=g, device=dev) * 0.125).to(dtype)
    kvs = [torch.randn(nl, kv_cap, 2 * c, generator=g, device=dev).to(
        dtype) for _ in range(caches)]
    row = torch.randn(nl, 2 * c, generator=g, device=dev).to(dtype)
    anc = torch.randint(0, lanes, (kv_cap, b, lanes), generator=g, device=dev)
    anc[min(pos, kv_cap - 1)] = torch.arange(lanes, device=dev)
    valid = (torch.arange(kv_cap, device=dev) <= pos)[:, None, None, None] & (
        anc[..., None] == torch.arange(lanes, device=dev))
    lb = torch.where(valid.permute(1, 2, 0, 3), 0.0, -1.0e30).contiguous()
    return q, kvs, row, lb


def rotating(fn, args):
    """A call of ``fn`` that takes the next of ``args`` each time. Over the
    decoder's six layers' caches (113 MB at B=8, 453 MB at B=32) the 50 MB
    L2 holds none when its turn comes: a cold read, as in the beam."""
    it = itertools.cycle(args)
    return lambda: fn(next(it))


def layer_case(g, dev, b: int, pos: int, layers: int = 1, lanes: int = BEAM,
               s_max: int = KV_CAP, s_enc: int = FRAMES + 2, c: int = 1024,
               heads: int = 16, dtype=torch.bfloat16):
    """One ``decoder_layer_step``'s inputs at the serving widths: b*lanes
    lanes (beam 3), C=1024, 16 heads, F=3072, bf16 (the conformer's
    decoder: C=768, 12 heads, fp32). ``layers`` decoder
    layers of random weights (N(0, 1/in) matrices, biases 0.02, LayerNorm
    scales around 1) as modules (``mods``) and packed (``packs``), each
    with its own (b*lanes, s_max=192, 2048) K|V cache (``kvs``) and (b,
    s_enc=377, 1024) source K/V (``srcs``); the step's x, the
    source-padding bias (utterance 1's last 10 rows padded) and a random
    ancestry's lane bias with the beam's contract (rows past pos masked,
    this step's row each lane's own)."""
    from avsr_tpu_torch.models.decoder import DecoderLayer
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl

    f = 3072
    nl = b * lanes
    case = dict(mods=[], packs=[], kvs=[], srcs=[])
    for _ in range(layers):
        layer = DecoderLayer(c, heads, f).to(dev)
        with torch.no_grad():
            for name, prm in layer.named_parameters():
                if "norm" in name and name.endswith("weight"):
                    prm.normal_(1.0, 0.1, generator=g)
                elif prm.dim() == 1:
                    prm.normal_(0.0, 0.02 if "norm" not in name else 0.1,
                                generator=g)
                else:
                    prm.normal_(0.0, prm.shape[1] ** -0.5, generator=g)
        case["mods"].append(layer)
        case["packs"].append(pdl.pack_layer_params(layer, dtype))
        case["kvs"].append(torch.randn(nl, s_max, 2 * c, generator=g,
                                       device=dev).to(dtype))
        case["srcs"].append(tuple(
            torch.randn(b, s_enc, c, generator=g, device=dev).to(dtype)
            for _ in range(2)))
    case["mem_bias"] = torch.zeros(b, s_enc, device=dev)
    case["mem_bias"][1, -10:] = -1.0e30
    case["x"] = torch.randn(nl, c, generator=g, device=dev).to(dtype)
    anc = torch.randint(0, lanes, (s_max, b, lanes), generator=g, device=dev)
    anc[min(pos, s_max - 1)] = torch.arange(lanes, device=dev)
    valid = (torch.arange(s_max, device=dev) <= pos)[:, None, None, None] & (
        anc[..., None] == torch.arange(lanes, device=dev))
    case["lb"] = torch.where(valid.permute(1, 2, 0, 3), 0.0,
                             -1.0e30).contiguous()
    return case


def scan_case(g, dev, t: int, c: int):
    """The CTC scorer's scan input: columns drifting 8.5 nats a frame (as
    the CTC terms do), -inf prefixes on a quarter of the columns, an all
    -inf column."""
    x = torch.randn(t, c, generator=g, device=dev) * 3.0
    x = x - 8.5 * torch.arange(t, device=dev).flip(0)[:, None]
    x[: t // 2, : c // 4] = float("-inf")
    x[:, -1] = float("-inf")
    return x


def decode_sdpa_ms(q, kvs, lb, lanes: int, heads: int):
    """(cold device ms, backend) of PyTorch's fused SDPA on
    ``decode_attention``'s inputs: the fused cache seen as strided (B, H,
    J*S, dh) K and V views, q as (B, H, K, dh), the lane bias as a (B, 1,
    K, J*S) additive mask in q's dtype, ``scale=1``, rotating over the
    caches. A time yardstick only: SDPA neither rounds P nor writes the
    row. Each backend of ``SDPA_BACKENDS`` is tried; the fastest kept."""
    from torch.nn import functional as F
    from torch.nn.attention import sdpa_kernel

    n, c = q.shape
    b, dh = n // lanes, c // heads
    s_max = kvs[0].shape[1]
    q4 = q.view(b, lanes, heads, dh).permute(0, 2, 1, 3)
    mask = lb.permute(0, 1, 3, 2).reshape(b, 1, lanes, lanes * s_max).to(
        q.dtype)

    def kv4(kv, half):  # (B, J, S, 2, H, dh) -> (B, H, J*S, dh), no copy
        v = kv.view(b, lanes, s_max, 2, heads, dh)[:, :, :, half]
        return v.permute(0, 3, 1, 2, 4).reshape(b, heads, lanes * s_max, dh)

    views = [(kv4(kv, 0), kv4(kv, 1)) for kv in kvs]
    check(all(k.data_ptr() == kv.data_ptr() for (k, _), kv in zip(views, kvs)),
          "the SDPA K view copies the cache")

    def make(backend):
        def call(kv):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    q4, kv[0], kv[1], attn_mask=mask, scale=1.0)

        return rotating(call, views)

    return fastest_sdpa_ms(
        make, "on the decode step",
        f"B={b}, H={heads}, K={lanes}, J*S={lanes * s_max}, dh={dh}, cold")


def phase_kernels(dev):
    """Each kernel vs its plain twin at the serving shapes; returns records."""
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
    # and shorter utterances; out within 8e-3 abs (two bf16 ulps below
    # |out| = 1), lse within 1e-4; the share of output elements equal to
    # the twin's bit for bit printed (both round the normalised P, C10)
    heads, t, d = 16, 384, 64
    n = B * heads
    q, k, v = (torch.randn(n, t, d, generator=g, device=dev).to(bf16)
               for _ in range(3))
    lens = torch.full((B,), 377, device=dev)
    lens[::5] = 200
    bias = torch.where(torch.arange(t, device=dev)[None] < lens[:, None],
                       0.0, -1.0e30).repeat_interleave(heads, 0).contiguous()
    scale = d ** -0.5
    got, lse = pfa.flash_attention_fwd(q, k, v, bias, scale)
    want, want_lse = pfa.flash_attention_plain(q, k, v, bias, scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    same = (got == want).float().mean().item()
    print(f"# flash_attention_fwd max_abs_err={err:.3e} lse_err={lse_err:.3e}"
          f" bit-equal to the twin: {same:.5f} of elements")
    check(err <= 8e-3 and lse_err <= 1e-4, "flash_attention_fwd disagrees")
    library_ms, backend = fused_sdpa_ms(q, k, v, bias, heads, scale, 0.0)
    records["flash_attention_fwd"] = dict(
        source="avsr_tpu_torch/csrc/flash_attention.cu",
        replaces="avsr_tpu/ops/pallas/flash_attention.py:296",
        max_abs_err=err,
        ms=cuda_ms(lambda: pfa.flash_attention_fwd(q, k, v, bias, scale)),
        plain_ms=cuda_ms(lambda: pfa.flash_attention_plain(q, k, v, bias, scale)),
        library_ms=library_ms,
        library=backend,
        # q.k and p.v: 2 flops per multiply-add, bf16 operands
        bound=bound(nbytes(q, k, v, bias, got, lse), 4 * n * t * t * d,
                    "bf16"),
    )

    # decode_attention: (B*3, 1024) bf16 queries over a (B*3, 192, 2048)
    # bf16 cache, H=16, at B=8 and B=32, pos 0, 100, 191 and 250 (pos >= S
    # clamps to S-1): the cache bit-equal to the twin's and the row
    # written. out, in bf16 as the kernel serves it and before the output's
    # rounding (q given in fp32, which the kernel and the twin round to
    # bf16 as they do the bf16 q, so the arithmetic is the same), within
    # pda.output_bound of the twin's, element by element: the most any
    # fp32 evaluation order of the TPU kernel's rounding points allows (a
    # p at a bf16 rounding boundary rounds either way: its ulp times |v|,
    # summed over the rows, plus the sums' fp32 rounding and one ulp of
    # the output's dtype; ROADMAP C27); and the bf16 output bit-equal to
    # that fp32 output rounded
    lanes, heads = BEAM, 16
    errs, ratios = [], {}
    for b in (B, 32):
        for pos in (0, 100, KV_CAP - 1, 250):
            q, (kv,), row, lb = decode_case(g, dev, b, pos)
            kv_plain = kv.clone()
            got, got_kv = pda.decode_attention(pos, q, kv, lb, lanes, heads,
                                               row)
            want, want_kv = pda.decode_attention_plain(pos, q, kv_plain, lb,
                                                       lanes, heads, row)
            got32, _ = pda.decode_attention(pos, q.float(), kv.clone(), lb,
                                            lanes, heads, row)
            want32, _ = pda.decode_attention_plain(pos, q.float(), kv.clone(),
                                                   lb, lanes, heads, row)
            torch.cuda.synchronize()
            check(got_kv is kv, "decode_attention did not update in place")
            check(torch.equal(got_kv, want_kv),
                  f"decode_attention cache differs at B={b}, pos={pos}")
            check(torch.equal(got_kv[:, min(pos, KV_CAP - 1)], row),
                  f"decode_attention row not written at B={b}, pos={pos}")
            check(torch.equal(got, got32.to(got.dtype)),
                  f"decode_attention's bf16 output is not its fp32 output "
                  f"rounded at B={b}, pos={pos}")
            for what, g_out, w_out, qq in (("bf16", got, want, q),
                                           ("unrounded", got32, want32,
                                            q.float())):
                bnd = pda.output_bound(pos, qq, kv_plain, lb, lanes, heads,
                                       row)
                diff = (g_out.float() - w_out.float()).abs()
                ratios[(b, pos, what)] = (diff / bnd).max().item()
                errs.append(diff.max().item())
                check(bool((diff <= bnd).all()),
                      f"decode_attention ({what}) beyond its output bound at "
                      f"B={b}, pos={pos}")
    err = max(errs)
    print(f"# decode_attention max_abs_err={err:.3e} (B={B} and 32, pos 0, "
          f"100, 191, 250, bf16 and unrounded); the largest difference over "
          f"its output bound: "
          + ", ".join(f"B={b} pos={p} {w} {r:.3f}"
                      for (b, p, w), r in ratios.items()))
    # timed at pos=250, where the whole 192-row cache is valid and read:
    # warm (one cache, which the L2 holds at B=8) and cold (rotating over
    # the six layers' caches, as the beam reads them)
    timed = {}
    for b in (B, 32):
        pos = 250
        q, kvs, row, lb = decode_case(g, dev, b, pos, caches=LAYERS)
        plan = pda.launch_plan(b, lanes, heads, 64, KV_CAP, pos, 2)

        def step(kv, q=q, row=row, lb=lb):
            return pda.decode_attention(pos, q, kv, lb, lanes, heads, row)

        warm = cuda_ms(lambda: step(kvs[0]))
        cold = cuda_ms(rotating(step, kvs))
        library_ms, backend = decode_sdpa_ms(q, kvs, lb, lanes, heads)
        copy_ms = cuda_ms(rotating(
            lambda kv, row=row: kv[:, KV_CAP - 1].copy_(row), kvs))
        # the whole cache, bias, q and row read, out and the row written;
        # q.k and p.v over lanes x rows for each lane's query
        bnd = bound(nbytes(q, kvs[0], lb, row, q, row),
                    4 * b * lanes * lanes * KV_CAP * 1024, "bf16")
        print(f"# decode_attention B={b} (cluster G={plan.cluster}, "
              f"{plan.grid[0] * plan.grid[1]} blocks, {plan.smem} B shared "
              f"memory): kernel warm {warm:.4f} ms, cold {cold:.4f} ms; "
              f"SDPA ({backend}) cold {library_ms:.4f} ms, the row write's "
              f"copy {copy_ms:.4f} ms; bound {bnd[0]:.6f} ms ({bnd[1]})")
        timed[b] = dict(warm=warm, cold=cold, library=library_ms,
                        bound=bnd, args=(q, kvs[0], lb, row))
    q, kv, lb, row = timed[B]["args"]
    records["decode_attention"] = dict(
        source="avsr_tpu_torch/csrc/decode_attention.cu",
        replaces="avsr_tpu/ops/pallas/decode_attention.py:222",
        max_abs_err=err,
        ms=timed[B]["cold"],
        plain_ms=cuda_ms(lambda: pda.decode_attention_plain(
            250, q, kv, lb, lanes, heads, row)),
        library_ms=timed[B]["library"],
        bound=timed[B]["bound"],
    )

    # topk: pre-beam (B*3, 5049) k=4 and flat beam (B, 15) k=3, at B=8 and
    # B=32, exact, with ties against the row maximum, a row of equal
    # values, rows with fewer than k entries above -inf (a round repeats
    # an earlier index) and rows off a 16-byte boundary; each shape timed
    # beside torch.topk. Records: the vocabulary rows at B=8
    # (``topk_lastdim``) and the flat top-k at B=8 (``topk_lastdim_flat``)
    errs, topk_ms = [], {}
    flat = BEAM * (PRE_BEAM + 1)  # the beam's (K, S' + 1) candidates
    for rows, vocab, kk in ((B * BEAM, VOCAB, PRE_BEAM), (B, flat, BEAM),
                            (32 * BEAM, VOCAB, PRE_BEAM), (32, flat, BEAM)):
        buf = torch.randn(rows * vocab + 1, generator=g, device=dev)
        for x in (buf[:-1].view(rows, vocab), buf[1:].view(rows, vocab)):
            x[:, vocab // 2] = x.amax(dim=1)
            x[:, -1] = x.amax(dim=1)
            x[1] = 0.5
            x[2] = float("-inf")
            x[2, vocab - 2] = 1.0
            x[3, : vocab - 1] = float("-inf")
            gv, gi = ptk.topk_lastdim(x, kk)
            wv, wi = ptk.topk_plain(x, kk)
            torch.cuda.synchronize()
            check(torch.equal(gi, wi) and torch.equal(gv, wv),
                  f"topk_lastdim disagrees at ({rows}, {vocab}) k={kk}")
            errs.append((gv - wv).abs().nan_to_num().max().item())
        x = torch.randn(rows, vocab, generator=g, device=dev)
        vals, ids = ptk.topk_lastdim(x, kk)
        topk_ms[rows, vocab] = dict(
            ms=cuda_ms(lambda: ptk.topk_lastdim(x, kk)),
            plain_ms=cuda_ms(lambda: ptk.topk_plain(x, kk)),
            library_ms=cuda_ms(lambda: torch.topk(x, kk)),
            # one comparison per element and round
            bound=bound(nbytes(x, vals, ids), kk * x.numel(), "fp32"))
        t = topk_ms[rows, vocab]
        print(f"# topk_lastdim ({rows}, {vocab}) k={kk}: kernel "
              f"{t['ms']:.4f} ms, torch.topk {t['library_ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.6f} ms")
    print(f"# topk_lastdim exact (max_abs_err={max(errs)})")
    for name, shape in (("topk_lastdim", (B * BEAM, VOCAB)),
                        ("topk_lastdim_flat", (B, flat))):
        records[name] = dict(source="avsr_tpu_torch/csrc/topk.cu",
                             replaces="avsr_tpu/ops/pallas/topk.py:47",
                             max_abs_err=max(errs), **topk_ms[shape])

    # cumlogsumexp: the scorer's (T, B*K*S') scans, (384, 96) at B=8 and
    # (384, 384) at B=32 (scan_case). The kernel's scan and the twin's tree
    # combine in other orders, each step rounding the running sum by a few
    # ulps; limit 1e-4 + 1e-6 |x| (the output's own rounding at |x| up to
    # ~3300), and -inf exactly where the twin has it
    scans = []
    for cols in (B * BEAM * PRE_BEAM, 32 * BEAM * PRE_BEAM):
        x = scan_case(g, dev, T_PAD, cols)
        got = psl.cumlogsumexp(x)
        want = psl.cumlogsumexp_plain(x)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        diff = (got - want).abs()[fin]
        err = diff.max().item()
        check(torch.equal(torch.isneginf(got), torch.isneginf(want))
              and not torch.isnan(got).any().item()
              and bool((diff <= 1e-4 + 1e-6 * want[fin].abs()).all()),
              f"cumlogsumexp disagrees at ({T_PAD}, {cols})")
        ms = cuda_ms(lambda: psl.cumlogsumexp(x))
        library_ms = cuda_ms(lambda: torch.logcumsumexp(x, 0))
        # per element: max, two subtractions, two exp, a multiply-add, log
        bnd = bound(nbytes(x, got), 8 * x.numel(), "fp32")
        print(f"# cumlogsumexp ({T_PAD}, {cols}): max_abs_err={err:.3e}, "
              f"kernel {ms:.4f} ms, torch.logcumsumexp {library_ms:.4f} ms, "
              f"bound {bnd[0]:.6f} ms ({bnd[1]})")
        scans.append((x, err, ms, library_ms, bnd))
    x, _, ms, library_ms, bnd = scans[0]  # the record: B=8's shape
    records["cumlogsumexp"] = dict(
        source="avsr_tpu_torch/csrc/scan_logsumexp.cu",
        replaces="avsr_tpu/ops/pallas/scan_logsumexp.py:27",
        max_abs_err=max(r[1] for r in scans),
        ms=ms,
        plain_ms=cuda_ms(lambda: psl.cumlogsumexp_plain(x)),
        library_ms=library_ms,
        bound=bnd,
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

    # topk_gather_rows: the pre-beam top-k with the CTC candidate rows
    # gathered in its launch, at the beam's B=8 (24, 5049) k=4 with the
    # (B*V, 384) table (the record) and beam 22's B=32 (704, 5049) k=33
    # with a (B*V, 128) one; ids and rows exact against the twins, one
    # launch each, timed beside the pair the beam launched before (the
    # top-k, the index add, row_gather)
    for b, lanes, kk, tp in ((B, BEAM, PRE_BEAM, T_PAD),
                             (EVAL_B, 22, 33, -(-EVAL_T // 128) * 128)):
        x = torch.randn(b, lanes, VOCAB, generator=g, device=dev)
        x[..., VOCAB // 2] = x.amax(dim=-1)
        x[1, 0] = 0.5
        table = torch.randn(b * VOCAB, tp, generator=g, device=dev)
        base = torch.arange(b, device=dev)[:, None, None] * VOCAB
        before = ptk.topk_gather_rows.launches
        got = ptk.topk_gather_rows(x, kk, table)
        wv, wi = ptk.topk_plain(x, kk)
        want_rows = prg.row_gather_plain(table, (wi + base).view(-1))
        torch.cuda.synchronize()
        check(ptk.topk_gather_rows.launches == before + 1
              and torch.equal(got[0], wv) and torch.equal(got[1], wi)
              and torch.equal(got[2], want_rows),
              f"topk_gather_rows disagrees at B={b}, beam {lanes}, k={kk}, "
              f"Tp={tp}")

        def pair(x=x, kk=kk, table=table, base=base):
            vals, ids = ptk.topk_lastdim(x, kk)
            return vals, ids, prg.row_gather(table, (ids + base).view(-1))

        r = dict(
            source="avsr_tpu_torch/csrc/topk.cu",
            replaces="avsr_tpu/ops/pallas/row_gather.py:43",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: ptk.topk_gather_rows(x, kk, table)),
            plain_ms=cuda_ms(lambda: (
                ptk.topk_plain(x, kk),
                prg.row_gather_plain(table, (wi + base).view(-1)))),
            library_ms=None,  # no one call takes the top-k and the rows
            # the logits read, the values, ids and rows written, the rows
            # read; one comparison per element and round
            bound=bound(nbytes(x, *got, got[2]), kk * x.numel(), "fp32"))
        pair_ms = cuda_ms(pair)
        print(f"# topk_gather_rows B={b}, beam {lanes}, k={kk}, Tp={tp}: "
              f"exact, one launch {r['ms']:.4f} ms against top-k + add + "
              f"row_gather {pair_ms:.4f} ms; plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]})")
        if b == B:
            records["topk_gather_rows"] = r

    # beam_update: step states with and without ties, mid-utterance and
    # at the forced last step of every lane, at B=8 and B=32; every output
    # bit-exact. Timed at both batches beside the launch floor (a kernel
    # that spins one cycle, timed the same way); B=8 is the record
    kw = BEAM_UPDATE_KW
    for b in (B, 32):
        for seed, i, ties in ((1, 40, False), (2, 40, True), (3, 200, True),
                              (4, FRAMES - 1, False)):
            st = step_state(seed, i, dev, ties, b)
            if i == FRAMES - 1:
                st["xlens"][:] = FRAMES  # every lane takes its forced step
            got = pbu.beam_update(i, *st.values(), **kw)
            want = pbu.beam_update_plain(i, *st.values(), **kw)
            torch.cuda.synchronize()
            for name, w in want.items():
                check(torch.equal(got[name], w), f"beam_update {name} differs "
                      f"at B={b}, step {i}, ties={ties}")
    print("# beam_update exact at B=8 and B=32 (4 step states each: ties, "
          "forced last step)")
    floor = cuda_ms(lambda: torch.cuda._sleep(1))
    for b in (32, B):
        st = step_state(5, 200, dev, True, b)
        out = pbu.beam_update(200, *st.values(), **kw)
        records["beam_update"] = dict(
            source="avsr_tpu_torch/csrc/beam_update.cu",
            replaces="avsr_tpu/ops/pallas/beam_update.py:35",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: pbu.beam_update(200, *st.values(), **kw)),
            plain_ms=cuda_ms(lambda: pbu.beam_update_plain(
                200, *st.values(), **kw)),
            library_ms=None,  # no one call does the step's bookkeeping
            # weighting (5 flops a candidate) and k rounds over the
            # candidates
            bound=bound(nbytes(*st.values(), *out.values()),
                        b * BEAM * (PRE_BEAM + 1) * (5 + BEAM), "fp32"),
        )
        r = records["beam_update"]
        print(f"# beam_update B={b}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
              f"({r['bound'][1]}), launch floor {floor:.4f} ms")
    records.update(wide_kernel_records(dev, g))
    for name, r in records.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"# {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")
    return records


def wide_kernel_records(dev, g):
    """ROADMAP C28: the paths that beams above the fast kernels' limits
    take, each held against its twin at B=8 (the serving shapes: a 192-row
    cache, L=377) and at the shapes phase 8's beams give them (B=32, the
    engine's batch; a 128-row cache and L=98, the 96-frame bucket of its
    3 s utterances; steps 0-74), and timed at phase 8's shapes.
    decode_attention at 22 lanes (``decode_attention_wide``), cache
    bit-equal and output within ``output_bound``, timed at step 74 cold
    beside fused SDPA. The top-k at beam 22's pre-beam rows (B*22, 5049)
    k=33 (``topk_lastdim_wide``), exact on rows with ties, equal values,
    +inf and too few finite entries, off a 16-byte boundary too, timed
    beside ``torch.topk``; beam 22's flat top-k (B, 22*34) k=22, which the
    list kernel takes, exact and timed. beam_update at K=10, S'=15 and at
    K=22, S'=33 (``beam_update_wide``), four step states each, every
    output bit for bit."""
    from avsr_tpu_torch.ops.kernels import beam_update as pbu
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import topk as ptk

    records = {}
    wide_k, wide_beam = 33, 22
    # (utterances, encoder frames, cache rows, steps, decode steps checked)
    shapes = ((B, FRAMES, KV_CAP, FRAMES, (0, 100, KV_CAP - 1, 250)),
              (EVAL_B, EVAL_T, EVAL_KV, EVAL_POS + 1, (0, 37, EVAL_POS)))

    ratios, errs = [], []
    for b, _, kv_cap, _, positions in shapes:
        for pos in positions:
            q, (kv,), row, lb = decode_case(g, dev, b, pos, lanes=wide_beam,
                                            kv_cap=kv_cap)
            kv_plain = kv.clone()
            before = pda.decode_attention.wide_launches
            got, got_kv = pda.decode_attention(pos, q, kv, lb, wide_beam, 16,
                                               row)
            want, want_kv = pda.decode_attention_plain(
                pos, q, kv_plain.clone(), lb, wide_beam, 16, row)
            bnd = pda.output_bound(pos, q, kv_plain, lb, wide_beam, 16, row)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            ratios.append((diff / bnd).max().item())
            errs.append(diff.max().item())
            check(pda.decode_attention.wide_launches == before + 1,
                  "decode_attention at 22 lanes did not launch its wide "
                  "kernel")
            check(torch.equal(got_kv, want_kv) and bool((diff <= bnd).all()),
                  f"decode_attention at 22 lanes disagrees at B={b}, "
                  f"S={kv_cap}, pos={pos}")
    print(f"# decode_attention 22 lanes at B={B} and {EVAL_B}: within "
          f"output_bound (largest ratio {max(ratios):.3f})")
    # timed cold at phase 8's shape (S=128, pos 74) at B=32 (the record)
    # and B=8, fused SDPA beside it; and at B=8 over the serving cache
    # (S=192, pos 250)
    for b, pos, kv_cap in ((B, 250, KV_CAP), (B, EVAL_POS, EVAL_KV),
                           (EVAL_B, EVAL_POS, EVAL_KV)):
        q, kvs, row, lb = decode_case(g, dev, b, pos, caches=LAYERS,
                                      lanes=wide_beam, kv_cap=kv_cap)
        out, _ = pda.decode_attention(pos, q, kvs[0], lb, wide_beam, 16, row)
        library_ms, backend = decode_sdpa_ms(q, kvs, lb, wide_beam, 16)
        # the kernel reads the pos + 1 rows of the prefix, no more
        used = (min(pos, kv_cap - 1) + 1) / kv_cap
        plan = pda.launch_plan(b, wide_beam, 16, 64, kv_cap, pos, 2)
        r = dict(
            source="avsr_tpu_torch/csrc/decode_attention.cu",
            replaces="avsr_tpu/ops/pallas/decode_attention.py:222",
            max_abs_err=max(errs),
            ms=cuda_ms(rotating(lambda kv: pda.decode_attention(
                pos, q, kv, lb, wide_beam, 16, row), kvs)),
            plain_ms=cuda_ms(lambda: pda.decode_attention_plain(
                pos, q, kvs[0], lb, wide_beam, 16, row)),
            library_ms=library_ms,
            bound=bound(nbytes(q, out, row, row) + used * nbytes(kvs[0], lb),
                        4 * b * wide_beam * wide_beam * used * kv_cap * 1024,
                        "bf16"))
        print(f"# decode_attention 22 lanes, B={b}, S={kv_cap}, pos {pos} "
              f"cold (G={plan.cluster}, tile {plan.tile}, chunk "
              f"{plan.chunk}, {plan.smem} B): kernel {r['ms']:.4f} ms, "
              f"SDPA ({backend}) {library_ms:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
              f"({r['bound'][1]})")
        del q, kvs, row, lb
    records["decode_attention_wide"] = r  # B=32, S=128, pos 74

    flat = wide_beam * (wide_k + 1)
    for b in (B, EVAL_B):
        rows = b * wide_beam
        buf = torch.randn(rows * VOCAB + 1, generator=g, device=dev)
        for x in (buf[:-1].view(rows, VOCAB), buf[1:].view(rows, VOCAB)):
            x[:, VOCAB // 2] = x.amax(dim=1)
            x[1] = 0.5
            x[2] = float("-inf")
            x[2, [0, VOCAB // 2, VOCAB - 2]] = torch.tensor(
                [-3.0, 1.0, 2.0], device=dev)
            x[3, 20:] = float("-inf")
            x[4, [7, VOCAB - 1]] = float("inf")
            before = ptk.topk_lastdim.wide_launches
            gv, gi = ptk.topk_lastdim(x, wide_k)
            wv, wi = ptk.topk_plain(x, wide_k)
            torch.cuda.synchronize()
            check(ptk.topk_lastdim.wide_launches == before + 1,
                  "topk_lastdim at k=33 did not launch its wide kernel")
            check(torch.equal(gi, wi) and torch.equal(gv, wv),
                  f"topk_lastdim disagrees at ({rows}, {VOCAB}) k={wide_k}")
        for shape, kk in (((rows, VOCAB), wide_k), ((b, flat), wide_beam)):
            x = torch.randn(*shape, generator=g, device=dev)
            vals, ids = ptk.topk_lastdim(x, kk)
            wv, wi = ptk.topk_plain(x, kk)
            torch.cuda.synchronize()
            check(torch.equal(ids, wi) and torch.equal(vals, wv),
                  f"topk_lastdim disagrees at {shape} k={kk}")
            r = dict(source="avsr_tpu_torch/csrc/topk.cu",
                     replaces="avsr_tpu/ops/pallas/topk.py:47",
                     max_abs_err=0.0,
                     ms=cuda_ms(lambda: ptk.topk_lastdim(x, kk)),
                     plain_ms=cuda_ms(lambda: ptk.topk_plain(x, kk)),
                     library_ms=cuda_ms(lambda: torch.topk(x, kk)),
                     # one comparison per element and round
                     bound=bound(nbytes(x, vals, ids), kk * x.numel(),
                                 "fp32"))
            print(f"# topk_lastdim {shape} k={kk}: kernel {r['ms']:.4f} ms, "
                  f"torch.topk {r['library_ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms")
            if b == EVAL_B and kk == wide_k:
                records["topk_lastdim_wide"] = r

    kw = BEAM_UPDATE_KW
    for b, t, kv_cap, last, _ in shapes:
        for k, sp in ((10, 15), (wide_beam, wide_k)):
            for seed, i, ties in ((1, 0, False), (2, 40, True),
                                  (3, last - 30, True), (4, last - 1, False)):
                st = step_state(seed, i, dev, ties, b, k, sp, t, kv_cap)
                if i == last - 1:
                    st["xlens"][:] = last
                before = pbu.beam_update.wide_launches
                got = pbu.beam_update(i, *st.values(), **kw)
                want = pbu.beam_update_plain(i, *st.values(), **kw)
                torch.cuda.synchronize()
                check(pbu.beam_update.wide_launches == before + 1,
                      f"beam_update at K={k}, S'={sp} did not launch its "
                      f"wide kernel")
                for name, w in want.items():
                    check(torch.equal(got[name], w), f"beam_update {name} "
                          f"differs at B={b}, K={k}, S'={sp}, L={t + 2}, "
                          f"step {i}, ties={ties}")
            st = step_state(5, 40, dev, True, b, k, sp, t, kv_cap)
            out = pbu.beam_update(40, *st.values(), **kw)
            r = dict(
                source="avsr_tpu_torch/csrc/beam_update.cu",
                replaces="avsr_tpu/ops/pallas/beam_update.py:35",
                max_abs_err=0.0,
                ms=cuda_ms(lambda: pbu.beam_update(40, *st.values(), **kw)),
                plain_ms=cuda_ms(lambda: pbu.beam_update_plain(
                    40, *st.values(), **kw)),
                library_ms=None,
                bound=bound(nbytes(*st.values(), *out.values()),
                            b * k * (sp + 1) * (5 + k), "fp32"))
            print(f"# beam_update wide K={k}, S'={sp}, B={b}, L={t + 2}: "
                  f"exact; kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
                  f"({r['bound'][1]})")
    records["beam_update_wide"] = r  # B=32, K=22, S'=33, L=98
    return records


def _attention_inputs(g, dev, dtype, b, heads, t, d):
    """q, k, v, dO (b*heads, t, d) in ``dtype`` and a ragged fp32 key bias
    (b*heads, t), one row per utterance as the encoder makes it: every
    fifth utterance 200 valid keys, every seventh 377, the rest all t."""
    n = b * heads
    q, k, v, do = (torch.randn(n, t, d, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    lens = torch.full((b,), t, device=dev)
    lens[::5] = min(200, t)
    lens[1::7] = min(377, t)
    bias = torch.where(torch.arange(t, device=dev)[None] < lens[:, None],
                       0.0, -1.0e30)
    return q, k, v, do, bias.repeat_interleave(heads, 0).contiguous()


def phase_train_kernels(dev):
    """The flash forward with in-kernel dropout and the two backward
    kernels at the training shapes (N = 6*16, T=384, D=64); returns their
    records (the forward's replaces the serving-shape one)."""
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa

    g = torch.Generator(device=dev).manual_seed(1)
    heads = TRAIN_HEADS // TRAIN_BATCH
    n, t, d = TRAIN_HEADS, T_PAD, 64
    rate, seed = 0.1, (20261016, 3)
    scale = d ** -0.5
    records = {}

    # the forward's keep mask, read out: with q = k = 0 and a zero bias
    # the attention is uniform, so out = (1/T) M V, and V = T x identity
    # blocks puts M's columns j0..j0+63 into the output; held bit for bit
    # against the twin's Philox draw, in both operand types
    for dtype in (torch.bfloat16, torch.float32):
        z = torch.zeros(n, t, d, device=dev, dtype=dtype)
        zb = torch.zeros(n, t, device=dev)
        cols = []
        for j0 in range(0, t, d):
            w = min(d, t - j0)
            vb = torch.zeros(n, t, d, device=dev)
            vb[:, j0:j0 + w, :w] = torch.eye(w, device=dev) * t
            out = pfa.flash_attention_fwd(z, z, vb.to(dtype), zb, 1.0, rate,
                                          seed)[0]
            cols.append(out[..., :w].float())
        kept = torch.cat(cols, dim=2) > 0.5
        want = pfa.dropout_keep_mask_plain(seed, n, t, rate, dev)
        frac = kept.float().mean().item()
        print(f"# flash dropout mask ({dtype}): kernel == twin "
              f"{torch.equal(kept, want)}, keep fraction {frac:.5f}")
        check(torch.equal(kept, want), f"flash dropout mask differs ({dtype})")
        check(abs(frac - (1 - rate)) <= 0.01, "flash keep fraction off")

    # forward with dropout, dQ/dK/dV with and without: against the twins
    # on the same inputs and seed, each within a limit relative to the
    # output's largest entry: fp32 1e-4 (sums in another order), bf16 2e-2
    # (the same roundings of P, P~ and dS; two ulps at the top); the bf16
    # forward's share of outputs bit-equal to the twin's printed; two
    # backward calls bit-identical
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q, k, v, do, bias = _attention_inputs(g, dev, dtype, TRAIN_BATCH,
                                              heads, t, d)
        for r, sd in ((0.0, None), (rate, seed)):
            out, lse = pfa.flash_attention_fwd(q, k, v, bias, scale, r, sd)
            if r:
                o2, _ = pfa.flash_attention_fwd(q, k, v, bias, scale, r, sd)
                o3, _ = pfa.flash_attention_fwd(q, k, 2 * v, bias, scale, r,
                                                sd)
                check(torch.equal(out, o2), "flash forward not deterministic")
                lin = ((o3.float() - 2 * out.float()).abs().max().item()
                       / out.float().abs().max().item())
                check(lin <= (1e-6 if dtype == torch.float32 else 1e-2),
                      f"flash forward not linear in V ({lin:.2e})")
            dq, delta = pfa.flash_attention_bwd_dq(q, k, v, bias, out, do,
                                                   lse, scale, r, sd)
            dk, dv = pfa.flash_attention_bwd_dkv(q, k, v, bias, do, lse,
                                                 delta, scale, r, sd)
            again = pfa.flash_attention_bwd(q, k, v, bias, out, do, lse,
                                            scale, r, sd)
            check(all(torch.equal(a, b_) for a, b_ in zip((dq, dk, dv),
                                                          again)),
                  f"flash backward not deterministic ({dtype}, rate={r})")
            w_out, _ = pfa.flash_attention_plain(q, k, v, bias, scale,
                                                 dropout_rate=r,
                                                 dropout_seed=sd)
            if dtype == torch.bfloat16:
                same = (out == w_out).float().mean().item()
                print(f"# flash forward bf16 rate={r}: bit-equal to the "
                      f"twin: {same:.5f} of elements")
            wants = pfa.flash_attention_bwd_plain(q, k, v, bias, out, do,
                                                  lse, scale, dropout_rate=r,
                                                  dropout_seed=sd)
            torch.cuda.synchronize()
            for name, got, want in (("out", out, w_out), ("dq", dq, wants[0]),
                                    ("dk", dk, wants[1]),
                                    ("dv", dv, wants[2])):
                e = (got.float() - want.float()).abs().max().item()
                m = want.float().abs().max().item()
                errs[(dtype, r, name)] = e
                print(f"# flash {name} {str(dtype)[6:]} rate={r}: max_abs_err"
                      f"={e:.3e} (limit {tol:g} x {m:.3f})")
                check(e <= tol * m, f"flash {name} {dtype} rate={r} disagrees")

    # times at the training precision, bf16, with dropout
    q, k, v, do, bias = _attention_inputs(g, dev, torch.bfloat16,
                                          TRAIN_BATCH, heads, t, d)
    out, lse = pfa.flash_attention_fwd(q, k, v, bias, scale, rate, seed)
    dq, delta = pfa.flash_attention_bwd_dq(q, k, v, bias, out, do, lse, scale,
                                           rate, seed)
    dk, dv = pfa.flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta, scale,
                                         rate, seed)
    fwd_lib = fused_sdpa_ms(q, k, v, bias, heads, scale, rate)
    bwd_lib = fused_sdpa_ms(q, k, v, bias, heads, scale, rate, do)
    bf16 = torch.bfloat16
    flops = 2 * n * t * t * d  # one (T x T x D) product
    records["flash_attention_fwd"] = dict(
        source="avsr_tpu_torch/csrc/flash_attention.cu",
        replaces="avsr_tpu/ops/pallas/flash_attention.py:296",
        max_abs_err=errs[(bf16, rate, "out")],
        ms=cuda_ms(lambda: pfa.flash_attention_fwd(q, k, v, bias, scale,
                                                   rate, seed)),
        plain_ms=cuda_ms(lambda: pfa.flash_attention_plain(
            q, k, v, bias, scale, dropout_rate=rate, dropout_seed=seed)),
        # fused SDPA, the bias as its mask, dropout_p at the same rate
        library_ms=fwd_lib[0],
        library=fwd_lib[1],
        # q.k and p.v; q, k, v, bias read once, out and lse written once
        bound=bound(nbytes(q, k, v, bias, out, lse), 2 * flops, "bf16"),
    )
    records["flash_attention_bwd_dq"] = dict(
        source="avsr_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="avsr_tpu/ops/pallas/flash_attention.py:335",
        max_abs_err=errs[(bf16, rate, "dq")],
        ms=cuda_ms(lambda: pfa.flash_attention_bwd_dq(
            q, k, v, bias, out, do, lse, scale, rate, seed)),
        # the twin computes dQ, dK and dV in one pass
        plain_ms=cuda_ms(lambda: pfa.flash_attention_bwd_plain(
            q, k, v, bias, out, do, lse, scale, dropout_rate=rate,
            dropout_seed=seed)),
        # fused SDPA's backward at the same dropout rate, all three
        # gradients in one call
        library_ms=bwd_lib[0],
        library=bwd_lib[1],
        # S and dP recomputed, dS K; q, k, v, O, dO, bias, lse read,
        # dq and delta written
        bound=bound(nbytes(q, k, v, out, do, bias, lse, dq, delta),
                    3 * flops, "bf16"),
    )
    records["flash_attention_bwd_dkv"] = dict(
        source="avsr_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="avsr_tpu/ops/pallas/flash_attention.py:335",
        max_abs_err=max(errs[(bf16, rate, "dk")], errs[(bf16, rate, "dv")]),
        ms=cuda_ms(lambda: pfa.flash_attention_bwd_dkv(
            q, k, v, bias, do, lse, delta, scale, rate, seed)),
        plain_ms=records["flash_attention_bwd_dq"]["plain_ms"],
        library_ms=bwd_lib[0],
        library=bwd_lib[1],
        # S and dP recomputed, P~^T dO and dS^T Q; q, k, v, dO, bias, lse,
        # delta read, dk and dv written
        bound=bound(nbytes(q, k, v, do, bias, lse, delta, dk, dv),
                    4 * flops, "bf16"),
    )
    for name, r in records.items():
        print(f"# {name} (training shape, bf16, dropout {rate}): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms ({r['library']}), bound "
              f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")
    # the cost of the in-kernel dropout draw: the same calls without it
    no_drop = dict(
        flash_attention_fwd=lambda: pfa.flash_attention_fwd(
            q, k, v, bias, scale),
        flash_attention_bwd_dq=lambda: pfa.flash_attention_bwd_dq(
            q, k, v, bias, out, do, lse, scale),
        flash_attention_bwd_dkv=lambda: pfa.flash_attention_bwd_dkv(
            q, k, v, bias, do, lse, delta, scale))
    for name, fn in no_drop.items():
        ms = cuda_ms(fn)
        print(f"# {name} (training shape, bf16) without dropout: {ms:.4f} "
              f"ms; the dropout draw costs {records[name]['ms'] - ms:.4f} "
              f"ms")
    return records


def _stem_inputs(g, dev, n, dtype, ties=False):
    """The stem tail's input (n, 64, 44, 44) in ``dtype``, its fp32 scale,
    bias and alpha, and a cotangent (n, 64, 22, 22), both channels-last as
    the stem gives them; ``ties`` repeats every value over a 2x2 block, so
    pooling windows hold equal maxima."""
    c = 64
    if ties:
        x = torch.randn(n, c, 22, 22, generator=g, device=dev)
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    else:
        x = torch.randn(n, c, 44, 44, generator=g, device=dev) * 2.0 + 0.3
    params = (1.0 + 0.1 * torch.randn(c, generator=g, device=dev),
              0.1 * torch.randn(c, generator=g, device=dev),
              0.25 + 0.05 * torch.randn(c, generator=g, device=dev))
    dout = torch.randn(n, c, 22, 22, generator=g, device=dev)
    cl = torch.channels_last
    return (x.to(dtype, memory_format=cl), params,
            dout.to(dtype, memory_format=cl))


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def phase_fuse_kernels(dev):
    """The fused stem tail's four kernels (B7) and the one-launch decoder
    layer (B9) against their twins at the training and serving shapes;
    returns their records."""
    from torch.nn import functional as F

    from avsr_tpu_torch.models.resnet import BatchNorm
    from avsr_tpu_torch.ops.kernels import stem_fuse as psf

    g = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    records = {}

    # B7 forward and backward: the kernels (statistics from the stats
    # kernel) against the twins on the same inputs. Limits relative to the
    # largest entry: bf16 2e-2 (two bf16 ulps; the sums' order moves mean
    # and rstd by ~1e-7, which can flip a rounding), fp32 2e-5 (the
    # output), 1e-4 (dx, through dbeta/M and dgamma/M); batch mean and var
    # and the three parameter gradients 1e-4 of their largest entry.
    def stem_case(n, dtype, ties, tol):
        x, (scale, bias, alpha), dout = _stem_inputs(g, dev, n, dtype, ties)
        s, q = psf.bn_prelu_pool_stats(x)
        m = float(x.numel() // x.shape[1])
        mean, var = s / m, q / m - (s / m) ** 2
        rstd = torch.rsqrt(var + 1e-5)
        p = psf._pack(mean, rstd, scale, bias, alpha)
        out = psf.bn_prelu_pool_apply(x, p)
        w_out, w_mean, w_var = psf.bn_prelu_pool_plain(x, scale, bias, alpha,
                                                       train=True)
        dz, red = psf.bn_prelu_pool_bwd1(x, p, dout)
        p2 = psf._pack(mean, rstd, scale * rstd, red[0] / m, red[1] / m)
        dx = psf.bn_prelu_pool_bwd2(x, p2, dz)
        wants = psf.bn_prelu_pool_bwd_plain(x, scale, bias, alpha, mean, rstd,
                                            dout)
        again = psf.bn_prelu_pool_bwd1(x, p, dout)
        w_dz = psf.bn_prelu_pool_bwd1_plain(x, scale, bias, alpha, mean, rstd,
                                            dout)[0]
        # the twin given the same p: the output bit for bit
        same_p = psf.bn_prelu_pool_plain(x, scale, bias, alpha, train=False,
                                         running_mean=mean, running_var=var)
        torch.cuda.synchronize()
        check(torch.equal(out, same_p), f"bn_prelu_pool_apply is not the "
              f"twin's bit for bit at N={n} {dtype}{' ties' if ties else ''}")
        errs = {"out": _rel_err(out, w_out), "mean": _rel_err(mean, w_mean),
                "var": _rel_err(var, w_var), "dz": _rel_err(dz, w_dz),
                "dx": _rel_err(dx, wants[0]),
                "dscale": _rel_err(red[1], wants[1]),
                "dbias": _rel_err(red[0], wants[2]),
                "dalpha": _rel_err(red[2], wants[3])}
        lims = {"out": tol, "dz": tol, "dx": tol if dtype == bf16 else 1e-4}
        print(f"# stem tail N={n} {str(dtype)[6:]}{' ties' if ties else ''}: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (limits {tol:g} out/dz/dx, 1e-4 others); dz bit-equal to "
              f"the twin's at {(dz == w_dz).float().mean().item():.6f} of "
              f"its elements")
        for k, v in errs.items():
            check(v <= lims.get(k, 1e-4), f"stem tail {k} disagrees at N={n} "
                  f"{dtype}{' ties' if ties else ''}")
        check(torch.equal(again[0], dz) and torch.equal(again[1], red),
              "bn_prelu_pool_bwd1 not deterministic")
        abs_errs = {
            "bn_prelu_pool_stats": max((mean - w_mean).abs().max().item(),
                                       (var - w_var).abs().max().item()),
            "bn_prelu_pool_apply": (out.float() - w_out.float()).abs().max()
            .item(),
            "bn_prelu_pool_bwd1": (red[[1, 0, 2]] - torch.stack(wants[1:]))
            .abs().max().item(),
            "bn_prelu_pool_bwd2": (dx.float() - wants[0].float()).abs().max()
            .item()}
        return x, (scale, bias, alpha), dout, p, p2, dz, mean, var, abs_errs

    for n, dtype, ties, tol in ((256, torch.float32, False, 2e-5),
                                (256, torch.float32, True, 2e-5),
                                (256, bf16, True, 2e-2)):
        stem_case(n, dtype, ties, tol)
    n_train = TRAIN_BATCH * T_PAD
    x, (scale, bias, alpha), dout, p, p2, dz, mean, var, abs_errs = (
        stem_case(n_train, bf16, False, 2e-2))
    rstd = torch.rsqrt(var + 1e-5)

    # eval at the serving shape: running statistics, the same p for both
    n_eval = B * (FRAMES + 2)
    xe = _stem_inputs(g, dev, n_eval, bf16)[0]
    rm = 0.1 * torch.randn(64, generator=g, device=dev)
    rv = 1.0 + torch.rand(64, generator=g, device=dev)
    pe = psf._pack(rm, torch.rsqrt(rv + 1e-5), scale, bias, alpha)
    eval_out = psf.bn_prelu_pool_apply(xe, pe)
    eval_want = psf.bn_prelu_pool_plain(xe, scale, bias, alpha, train=False,
                                        running_mean=rm, running_var=rv)
    torch.cuda.synchronize()
    print(f"# stem tail eval N={n_eval} bf16: out bit-equal to the twin's "
          f"{torch.equal(eval_out, eval_want)} (the same p)")
    check(torch.equal(eval_out, eval_want),
          "bn_prelu_pool_apply (eval) is not the twin's bit for bit")
    eval_ms = cuda_ms(lambda: psf.bn_prelu_pool_apply(xe, pe))
    eval_bound = bound(nbytes(xe, eval_out),
                       4 * xe.numel() + 8 * eval_out.numel(), "fp32")
    # the serving entry point on the stem's channels-last x (no copy), and
    # on an NCHW copy of it (which the wrapper copies back first)
    xe_nchw = xe.contiguous()

    def serve_stem(v):
        return psf.bn_prelu_pool(v, scale, bias, alpha, train=False,
                                 running_mean=rm, running_var=rv)

    wrap_ms, nchw_ms = cuda_ms(lambda: serve_stem(xe)), cuda_ms(
        lambda: serve_stem(xe_nchw))
    print(f"# bn_prelu_pool_apply eval (N={n_eval}, bf16): kernel "
          f"{eval_ms:.4f} ms, bound {eval_bound[0]:.6f} ms ({eval_bound[1]}); "
          f"bn_prelu_pool(train=False) {wrap_ms:.4f} ms on channels-last x, "
          f"{nchw_ms:.4f} ms on NCHW x (copied first)")
    del xe_nchw

    # times at the training shape (N = 6 * 384, bf16, channels-last). Each
    # kernel's twin is its own plain pass: the fp32 sums, the eval-form
    # forward, the backward up to dz and the sums, the dx expression. One
    # PyTorch call computes two of them (torch's own CUDA BatchNorm passes):
    # batch_norm_stats (mean and invstd) and batch_norm_backward_elemt (dx
    # from dz, the sums and the statistics)
    sums = psf.bn_prelu_pool_stats(x)
    out = psf.bn_prelu_pool_apply(x, p)
    dz2, red = psf.bn_prelu_pool_bwd1(x, p, dout)
    dx = psf.bn_prelu_pool_bwd2(x, p2, dz)
    dgamma, dbeta = red[1], red[0]
    count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.int32,
                       device=dev)

    def library_dx():
        return torch.batch_norm_backward_elemt(dz, x, mean, rstd, scale,
                                               dbeta, dgamma / rstd, count)

    lib_err = _rel_err(library_dx(), dx)
    print(f"# batch_norm_backward_elemt vs bn_prelu_pool_bwd2: {lib_err:.2e} "
          f"of the largest entry")
    check(lib_err <= 2e-2, "the library call of bwd2 computes another dx")
    src = "avsr_tpu_torch/csrc/stem_fuse.cu"
    base = "avsr_tpu/ops/pallas/stem_fuse.py"
    # operations: the sums 3 an element; normalise, PReLU 4 an element and
    # the 9-way max 8 an output; the backward ~20 and 6 an element
    records["bn_prelu_pool_stats"] = dict(
        source=src, replaces=f"{base}:138",
        ms=cuda_ms(lambda: psf.bn_prelu_pool_stats(x)),
        plain_ms=cuda_ms(lambda: psf._batch_stats_plain(x.float())),
        library_ms=cuda_ms(lambda: torch.batch_norm_stats(x, 1e-5)),
        bound=bound(nbytes(x, *sums), 3 * x.numel(), "fp32"))
    records["bn_prelu_pool_apply"] = dict(
        source=src, replaces=f"{base}:163",
        ms=cuda_ms(lambda: psf.bn_prelu_pool_apply(x, p)),
        plain_ms=cuda_ms(lambda: psf.bn_prelu_pool_plain(
            x, scale, bias, alpha, train=False, running_mean=mean,
            running_var=var)),
        library_ms=None,  # no one call normalises, activates and pools
        bound=bound(nbytes(x, out), 4 * x.numel() + 8 * out.numel(),
                    "fp32"),
        eval_ms=eval_ms, eval_bound=eval_bound)
    records["bn_prelu_pool_bwd1"] = dict(
        source=src, replaces=f"{base}:179",
        ms=cuda_ms(lambda: psf.bn_prelu_pool_bwd1(x, p, dout)),
        plain_ms=cuda_ms(lambda: psf.bn_prelu_pool_bwd1_plain(
            x, scale, bias, alpha, mean, rstd, dout)),
        library_ms=None,  # no one call routes the pool's gradient and sums
        bound=bound(nbytes(x, dout, dz2, red), 20 * x.numel(), "fp32"))
    records["bn_prelu_pool_bwd2"] = dict(
        source=src, replaces=f"{base}:217",
        ms=cuda_ms(lambda: psf.bn_prelu_pool_bwd2(x, p2, dz)),
        plain_ms=cuda_ms(lambda: psf.bn_prelu_pool_bwd2_plain(
            x, scale, mean, rstd, dz, dgamma, dbeta)),
        library_ms=cuda_ms(library_dx),
        bound=bound(nbytes(x, dz, dx), 6 * x.numel(), "fp32"))
    for name, e in abs_errs.items():
        records[name]["max_abs_err"] = e

    # as information: the eager composition the kernels replace (the
    # port's unfused stem tail in training: folded BN, PReLU, max_pool2d),
    # forward, and forward + backward against the fused autograd function
    bn = BatchNorm(64, folded=True).to(dev)
    prelu = torch.nn.PReLU(64).to(dev, bf16)
    xr = x.detach().requires_grad_()
    sp = [v.to(bf16).requires_grad_() for v in (scale, bias, alpha)]

    def composed():
        return F.max_pool2d(prelu(bn(xr, True)), 3, stride=2, padding=1)

    def fused():
        return psf.bn_prelu_pool(xr, *sp, train=True)[0]

    comp = {name: (cuda_ms(lambda: fn().detach()),
                   cuda_ms(lambda: torch.autograd.grad(fn(), xr, dout)))
            for name, fn in (("composition", composed), ("fused", fused))}
    print(f"# stem tail at N={n_train} bf16 channels-last, forward / "
          f"forward+backward: eager composition "
          f"{comp['composition'][0]:.4f} / {comp['composition'][1]:.4f} ms, "
          f"bn_prelu_pool(train=True) {comp['fused'][0]:.4f} / "
          f"{comp['fused'][1]:.4f} ms")
    del x, xr, dout, dz, dz2, dx, out, xe, eval_out, eval_want

    records["decoder_layer_step"] = layer_kernel_record(dev, g)
    for name, r in records.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"# {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib}, bound {r['bound'][0]:.6f} ms "
              f"({r['bound'][1]})")
    return records


def layer_kernel_record(dev, g):
    """B9 against its twin and timed (phase 3); returns its record."""
    from avsr_tpu_torch.models.decoder import TransformerDecoder
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl

    # B9 at the serving widths (layer_case) at B=8 and B=32 (24 and 96
    # lanes, one launch each), pos 0, 100, 191 and 250 (past the cap: all
    # rows plus the fresh one, row 191 written). x_out and the written row
    # within 2e-2 of their largest entry (bf16 roundings of the same
    # operands; fp32 sums in other orders); the rest of the cache
    # untouched; a second call bit-equal to the first
    lanes, heads, c, f = BEAM, 16, 1024, 3072
    s_max, s_enc = KV_CAP, FRAMES + 2
    errs, timed = [], {}
    for b in (B, 32):
        nl = b * lanes
        for pos in (0, 100, s_max - 1, 250):
            case = layer_case(g, dev, b, pos)
            kv = case["kvs"][0]
            kv_plain, kv_again = kv.clone(), kv.clone()
            args = (case["x"], kv, *case["srcs"][0], case["mem_bias"],
                    case["lb"], case["packs"][0], lanes, heads)
            before = pdl.decoder_layer_step.launches
            got, got_kv = pdl.decoder_layer_step(pos, *args)
            launches = pdl.decoder_layer_step.launches - before
            again, _ = pdl.decoder_layer_step(
                pos, case["x"], kv_again, *args[2:])
            want, want_kv = pdl.decoder_layer_step_plain(
                pos, case["x"], kv_plain, *args[2:])
            torch.cuda.synchronize()
            row = min(pos, s_max - 1)
            rest = torch.arange(s_max, device=dev) != row
            check(launches == 1, f"decoder_layer_step took {launches} "
                  f"launches at B={b}")
            check(got_kv is kv and torch.equal(kv[:, rest], kv_plain[:, rest]),
                  f"decoder_layer_step touched other cache rows at B={b}, "
                  f"pos={pos}")
            check(torch.equal(got, again) and torch.equal(kv, kv_again),
                  f"decoder_layer_step not repeatable at B={b}, pos={pos}")
            e_x, e_row = _rel_err(got, want), _rel_err(kv[:, row],
                                                       kv_plain[:, row])
            if b == B:
                errs.append((got.float() - want.float()).abs().max().item())
            print(f"# decoder_layer_step B={b} pos={pos}: x_out {e_x:.2e}, "
                  f"row {e_row:.2e} of their largest entry (limit 2e-2)")
            check(e_x <= 2e-2 and e_row <= 2e-2,
                  f"decoder_layer_step disagrees at B={b}, pos={pos}")
            del case, kv, kv_plain, kv_again
        # timed at pos=250 (every cache row read), the scratch made once as
        # the decoder's cache keeps it: warm (one layer's weights and
        # caches) and cold (rotating over six layers', ~150 MB at B=8,
        # which the 50 MB L2 cannot hold; the record's time); beside it the
        # unfused step of the same layers (decode_attention and ~15 eager
        # ops) on the decoder's own cache, warm and cold alike
        pos = 250
        case = layer_case(g, dev, b, pos, layers=LAYERS)
        scratch = pdl.layer_scratch(nl, c, f, dev)

        def fused(i, case=case, scratch=scratch):
            return pdl.decoder_layer_step(
                pos, case["x"], case["kvs"][i], *case["srcs"][i],
                case["mem_bias"], case["lb"], case["packs"][i], lanes, heads,
                scratch=scratch)

        warm = cuda_ms(lambda: fused(0))
        cold = cuda_ms(rotating(fused, range(LAYERS)))
        dec = TransformerDecoder(VOCAB, c, heads, f, layers=LAYERS,
                                 cache_dtype="bfloat16",
                                 param_dtype="bfloat16").to(dev)
        for i, mod in enumerate(case["mods"]):
            dec.decoders[i].load_state_dict(mod.state_dict())
        cache = dec.init_cache(
            torch.randn(b, s_enc, c, generator=g, device=dev), s_max, lanes)
        mask = (case["mem_bias"] == 0)[:, None, :]
        with torch.inference_mode():
            def unfused(i, cache=cache, mask=mask, case=case):
                return dec.layer_step(i, case["x"], pos, cache, mask,
                                      case["lb"], lanes)

            unfused_warm = cuda_ms(lambda: unfused(0))
            unfused_cold = cuda_ms(rotating(unfused, range(LAYERS)))
        packed, kv = case["packs"][0], case["kvs"][0]
        # the weights, x, the whole cache, the source K/V and the biases
        # read once; x_out and the row written. Products: 2 N FLOPs a
        # weight element, and q.k, p.v over the cache and the source rows
        bnd = bound(sum(nbytes(t) for t in packed)
                    + nbytes(case["x"], kv, *case["srcs"][0],
                             case["mem_bias"], case["lb"], case["x"],
                             kv[:, 0]),
                    2 * nl * 12 * c * c
                    + 4 * nl * c * (lanes * s_max + s_enc), "bf16")
        plan, smem = pdl.card_plan(nl, lanes, heads, c, f, s_max, s_enc,
                                   torch.bfloat16, torch.bfloat16, dev.index)
        print(f"# decoder_layer_step B={b} ({nl} lanes, one launch of "
              f"{plan.grid} blocks, {smem} B shared memory, K slices "
              f"{plan.slices}): kernel warm {warm:.4f} ms, cold "
              f"{cold:.4f} ms; the unfused layer step warm "
              f"{unfused_warm:.4f} ms, cold {unfused_cold:.4f} ms; bound "
              f"{bnd[0]:.6f} ms ({bnd[1]})")
        timed[b] = dict(cold=cold, bound=bnd,
                        args=(case["x"], kv, *case["srcs"][0],
                              case["mem_bias"], case["lb"], packed))
        del case, dec, cache, scratch
    wide_layer_check(dev, g)
    args = timed[B]["args"]
    return dict(
        source="avsr_tpu_torch/csrc/decoder_layer.cu",
        replaces="avsr_tpu/ops/pallas/decoder_layer.py:81",
        max_abs_err=max(errs),
        ms=timed[B]["cold"],
        plain_ms=cuda_ms(lambda: pdl.decoder_layer_step_plain(
            250, *args, lanes, heads)),
        library_ms=None,  # no one call runs a decoder layer's step
        bound=timed[B]["bound"],
    )


def wide_layer_check(dev, g):
    """B9 above 8 lanes (ROADMAP C30) at the shapes phase 8's fused beam of
    22 gives it: B=32 (704 lanes), a 128-row cache, 98 source rows, at pos
    0, 37, 74 (one pass of the self-attention's scores at the first, two
    over tiles of its rows at the others) and 130 (past the cap): one
    launch, two calls bit-equal, the rest of the cache untouched, x_out and
    the written row within 2e-2 of their largest entry of the twin's (as
    phase 3 holds B9 at beam 3). Timed at pos 74 warm and cold (rotating
    over six layers' weights and caches) beside its bound."""
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl

    lanes, heads, c, f = 22, 16, 1024, 3072
    s_max, s_enc, b = EVAL_KV, EVAL_T + 2, EVAL_B
    nl = b * lanes
    for pos in (0, 37, EVAL_POS, s_max + 2):
        case = layer_case(g, dev, b, pos, lanes=lanes, s_max=s_max,
                          s_enc=s_enc)
        kv = case["kvs"][0]
        kv_plain, kv_again = kv.clone(), kv.clone()
        args = (case["x"], kv, *case["srcs"][0], case["mem_bias"],
                case["lb"], case["packs"][0], lanes, heads)
        before = pdl.decoder_layer_step.launches
        got, got_kv = pdl.decoder_layer_step(pos, *args)
        launches = pdl.decoder_layer_step.launches - before
        again, _ = pdl.decoder_layer_step(pos, case["x"], kv_again, *args[2:])
        want, _ = pdl.decoder_layer_step_plain(pos, case["x"], kv_plain,
                                               *args[2:])
        torch.cuda.synchronize()
        row = min(pos, s_max - 1)
        rest = torch.arange(s_max, device=dev) != row
        e_x, e_row = _rel_err(got, want), _rel_err(kv[:, row],
                                                   kv_plain[:, row])
        print(f"# decoder_layer_step {lanes} lanes, B={b}, S={s_max}, "
              f"pos={pos}: x_out {e_x:.2e}, row {e_row:.2e} of their "
              f"largest entry (limit 2e-2)")
        check(launches == 1 and got_kv is kv
              and torch.equal(kv[:, rest], kv_plain[:, rest])
              and torch.equal(got, again) and torch.equal(kv, kv_again)
              and e_x <= 2e-2 and e_row <= 2e-2,
              f"decoder_layer_step at {lanes} lanes disagrees at pos={pos}")
        del case, kv, kv_plain, kv_again
    pos = EVAL_POS
    case = layer_case(g, dev, b, pos, layers=LAYERS, lanes=lanes,
                      s_max=s_max, s_enc=s_enc)
    scratch = pdl.layer_scratch(nl, c, f, dev)

    def fused(i):
        return pdl.decoder_layer_step(
            pos, case["x"], case["kvs"][i], *case["srcs"][i],
            case["mem_bias"], case["lb"], case["packs"][i], lanes, heads,
            scratch=scratch)

    warm = cuda_ms(lambda: fused(0))
    cold = cuda_ms(rotating(fused, range(LAYERS)))
    kv = case["kvs"][0]
    used = (pos + 1) / s_max  # the rows of the prefix, no more
    bnd = bound(sum(nbytes(t) for t in case["packs"][0])
                + nbytes(case["x"], *case["srcs"][0], case["mem_bias"],
                         case["x"], kv[:, 0])
                + used * nbytes(kv, case["lb"]),
                2 * nl * 12 * c * c
                + 4 * nl * c * (lanes * (pos + 1) + s_enc), "bf16")
    plan, smem = pdl.card_plan(nl, lanes, heads, c, f, s_max, s_enc,
                               torch.bfloat16, torch.bfloat16, dev.index)
    print(f"# decoder_layer_step {lanes} lanes, B={b} ({nl} lanes, one "
          f"launch of {plan.grid} blocks, {smem} B shared memory), S={s_max}, "
          f"pos {pos}: warm {warm:.4f} ms, cold {cold:.4f} ms; bound "
          f"{bnd[0]:.6f} ms ({bnd[1]})")
    del case, scratch


@contextlib.contextmanager
def stem_layouts():
    """Yields a list that records, for each x the ResNet's stem hands to
    ``bn_prelu_pool``, whether it is channels-last already: the kernels'
    layout, so the fused tail copies nothing."""
    from avsr_tpu_torch.models import resnet

    seen, real = [], resnet.bn_prelu_pool

    def spy(x, *args, **kwargs):
        seen.append(x.is_contiguous(memory_format=torch.channels_last))
        return real(x, *args, **kwargs)

    resnet.bn_prelu_pool = spy
    try:
        yield seen
    finally:
        resnet.bn_prelu_pool = real


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
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa
    from avsr_tpu_torch.ops.kernels import row_gather as prg
    from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl
    from avsr_tpu_torch.ops.kernels import stem_fuse as psf
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
                ptk.topk_lastdim, ptk.topk_gather_rows, prg.row_gather,
                psl.cumlogsumexp, pbu.beam_update, pdl.decoder_layer_step,
                psf.bn_prelu_pool_stats, psf.bn_prelu_pool_apply)
    layers = cfg.encoder.num_hidden_layers
    audio_s = B * SEGMENT_SECONDS

    def serve(name, mode, ctc_weight, fused, rec=rec):
        rec.ctc_weight, rec.fused_bookkeeping = ctc_weight, fused
        rec.transcribe_batch(audio, video, mode=mode)  # warm-up
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        ptk.topk_lastdim.flat_launches = 0
        t0 = time.perf_counter()
        out = rec.transcribe_batch(audio, video, mode=mode)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        # top-k's two kernels: the vocabulary rows and the flat (B, 15)
        launches["topk_lastdim_flat"] = ptk.topk_lastdim.flat_launches
        launches["topk_lastdim"] -= ptk.topk_lastdim.flat_launches
        check(len(out) == B, f"{name}: wrong number of transcripts")
        for toks in out:
            check(toks.ndim == 1 and ((toks >= 0) & (toks < cfg.odim)).all(),
                  f"{name}: token ids out of range")
        print(f"# {name}: transcribe_batch {1e3 * wall:.1f} ms -> "
              f"{audio_s / wall:.1f} audio-s/s; launches {launches}")
        check(launches["flash_attention_fwd"] >= layers,
              f"{name}: flash_attention_fwd not launched once per layer")
        return launches, wall

    runs, walls = {}, {}
    for name, ctc_weight, fused in (("beam ctc_weight=0.1", 0.1, False),
                                    ("beam ctc_weight=0.1 fused", 0.1, True),
                                    ("beam ctc_weight=0", 0.0, False)):
        n, walls[name] = serve(name, "beam", ctc_weight, fused)
        runs[name] = n
        # with both switches off, the paths launch the kernels they did
        check(n["decoder_layer_step"] == 0 and n["bn_prelu_pool_apply"] == 0
              and n["bn_prelu_pool_stats"] == 0,
              f"{name}: a fused-path kernel ran with the switches off")
        steps = n["decode_attention"] // cfg.dlayers
        check(steps >= 1 and n["decode_attention"] == steps * cfg.dlayers,
              f"{name}: decode_attention not launched per layer and step")
        check(n["topk_lastdim"] >= steps
              and (fused or n["topk_lastdim_flat"] >= steps),
              f"{name}: topk_lastdim not launched every step")
        # with CTC the pre-beam top-k gathers the candidates' rows in its
        # launch: one topk_gather_rows a step, no row_gather
        check(n["topk_gather_rows"] == (steps if ctc_weight else 0)
              and n["row_gather"] == 0,
              f"{name}: topk_gather_rows {n['topk_gather_rows']} and "
              f"row_gather {n['row_gather']} launches in {steps} steps")
        if ctc_weight:
            check(n["cumlogsumexp"] >= 2 * steps,
                  f"{name}: cumlogsumexp not launched twice a step")
        check((n["beam_update"] >= steps) if fused
              else n["beam_update"] == 0,
              f"{name}: beam_update launches {n['beam_update']}")
    runs["greedy"], _ = serve("greedy", "greedy", 0.1, False)

    # the same weights with decode_fused_layer and AVSR_FUSED_STEM_EVAL=1:
    # one decoder_layer_step per layer and step (steps past 192 run the
    # capped-cache case, C22), no decode_attention, one stem apply an
    # encode
    fcfg = copy.deepcopy(cfg)
    fcfg.decode_fused_layer = True
    with torch.device(dev):
        fmodel = AVSRModel(fcfg)
    fmodel.load_state_dict(model.state_dict())
    frec = Recognizer(model=fmodel, cfg=fcfg, device=dev,
                      t_buckets=(FRAMES + 2,), max_decode_tokens=KV_CAP,
                      encode_dtype="bfloat16", video_wire="delta2")
    fused_name = "beam ctc_weight=0.1, fused layer and stem"
    os.environ["AVSR_FUSED_STEM_EVAL"] = "1"
    try:
        with stem_layouts() as seen:
            n, walls[fused_name] = serve(fused_name, "beam", 0.1, False, frec)
        fy, fl, fs, f_enc, f_beam = _stage_times(frec, audio, video)[:5]
    finally:
        del os.environ["AVSR_FUSED_STEM_EVAL"]
    runs[fused_name] = n
    check(seen and all(seen), f"{fused_name}: the stem's x was not "
          f"channels-last ({seen}), so the fused tail copied it")
    steps = n["decoder_layer_step"] // cfg.dlayers
    check(steps >= 1 and n["decoder_layer_step"] == steps * cfg.dlayers
          and n["decode_attention"] == 0,
          f"{fused_name}: decoder_layer_step not once per layer and step")
    check(n["bn_prelu_pool_apply"] == 1 and n["bn_prelu_pool_stats"] == 0,
          f"{fused_name}: not one stem apply per encode")
    check(n["topk_gather_rows"] == steps and n["row_gather"] == 0
          and n["cumlogsumexp"] >= 2 * steps,
          f"{fused_name}: the CTC scorer's kernels not launched every step")
    check(torch.isfinite(fs).all().item(), "fused-layer beam scores")

    # stage times (device-synchronised host clock) at the defaults
    rec.ctc_weight, rec.fused_bookkeeping = 0.1, False
    yseqs, ylens, scores, enc_ms, beam_ms, feats, ctc, lens = _stage_times(
        rec, audio, video)
    rec.fused_bookkeeping = True
    s2 = time.perf_counter()
    by, bl, bs = rec.beam(feats, ctc, lens)
    torch.cuda.synchronize()
    fused_beam_ms = 1e3 * (time.perf_counter() - s2)
    check(torch.isfinite(scores).all().item(), "beam scores not finite")
    check(torch.equal(yseqs, by) and torch.equal(ylens, bl)
          and torch.equal(scores, bs),
          "fused bookkeeping differs from unfused on the card")
    print(f"# {gpu_name}: encode {enc_ms:.1f} ms, beam ctc_weight=0.1 "
          f"{beam_ms:.1f} ms unfused, {fused_beam_ms:.1f} ms fused "
          f"(bit-identical; longest hypothesis {int(ylens.max().item())} "
          f"tokens with sos/eos; B={B}, T={FRAMES})")
    default = "beam ctc_weight=0.1"
    print(f"# {gpu_name}: fused layer and stem vs the default: "
          f"{audio_s / walls[fused_name]:.1f} vs "
          f"{audio_s / walls[default]:.1f} audio-s/s; encode {f_enc:.1f} vs "
          f"{enc_ms:.1f} ms, beam {f_beam:.1f} vs {beam_ms:.1f} ms; "
          f"{steps} vs {runs[default]['decode_attention'] // cfg.dlayers} "
          f"steps; tokens equal to the default's: "
          f"{torch.equal(fy, yseqs) and torch.equal(fl, ylens)}")
    return runs


def _stage_times(rec, audio, video):
    """(yseqs, lengths, scores, encode ms, beam ms, feats, CTC log-probs,
    lengths of the frames): host clock around device-synchronised stages;
    the CTC log-probs checked."""
    aud, vid, lens, _ = rec._pad_batch(audio, video)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    feats, ctc = rec.encode(aud, vid, lens)
    torch.cuda.synchronize()
    s1 = time.perf_counter()
    yseqs, ylens, scores = rec.beam(feats, ctc, lens)
    torch.cuda.synchronize()
    s2 = time.perf_counter()
    check(torch.isfinite(ctc).all().item() and tuple(ctc.shape) ==
          (B, FRAMES + 2, rec.cfg.odim), "CTC log-probs malformed")
    return (yseqs, ylens, scores, 1e3 * (s1 - s0), 1e3 * (s2 - s1), feats,
            ctc, lens)


def phase_parity(dev):
    """Full width, B=2, T=64, joint CTC/attention beam at ctc_weight=0.1:
    the CUDA path with its bookkeeping fused (beam_update) vs the CPU path
    (the plain twins, unfused), in fp32 and at the serving precision (bf16
    encode, bf16 decoder weights and K|V cache); then in fp32 with
    decode_fused_layer and AVSR_FUSED_STEM_EVAL=1 on both sides (the
    kernels on the card, their twins on the CPU)."""
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
    for dtype, fused, ctc_tol, score_tol in (
            ("float32", False, 1e-3, 1e-4), ("bfloat16", False, 0.2, 2e-2),
            ("float32", True, 1e-3, 1e-4)):
        cfg = flagship_config(dtype)
        cfg.decode_fused_layer = fused
        if fused:
            os.environ["AVSR_FUSED_STEM_EVAL"] = "1"
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
        os.environ.pop("AVSR_FUSED_STEM_EVAL", None)
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
        what = ", fused layer and stem" if fused else ""
        print(f"# slice parity cuda (fused) vs cpu (unfused), "
              f"ctc_weight=0.1 ({dtype}{what}, B=2, T=64): ctc "
              f"max_abs_err={err:.3e} (limit {ctc_tol:g}; {dtype} vs "
              f"float32 on cuda {gap:.3e}); beam score "
              f"rel_err={score_err:.3e} (limit {score_tol:g}); beam tokens "
              f"equal={same_beam} (lengths {cu['ylen'].tolist()}); greedy "
              f"tokens equal={same_greedy}")
        check(err <= ctc_tol, f"{dtype}{what} CTC log-probs: cuda vs cpu")
        check(score_err <= score_tol,
              f"{dtype}{what} beam scores: cuda vs cpu")
        if dtype == "float32":
            check(same_beam and same_greedy,
                  f"fp32{what} tokens: cuda vs cpu")


TWINS = {"flash_attention": ("flash_attention_plain",
                             "flash_attention_bwd_plain", "_bwd_from_delta",
                             "dropout_keep_mask_plain"),
         "stem_fuse": ("bn_prelu_pool_plain", "bn_prelu_pool_bwd_plain",
                       "bn_prelu_pool_bwd1_plain", "bn_prelu_pool_bwd2_plain",
                       "pool_bwd_plain", "_batch_stats_plain")}


SERVING_TWINS = {"decode_attention": ("decode_attention_plain",),
                 "topk": ("topk_plain", "row_gather_plain"),
                 "row_gather": ("row_gather_plain",),
                 "scan_logsumexp": ("cumlogsumexp_plain",),
                 "beam_update": ("beam_update_plain",),
                 "decoder_layer": ("decoder_layer_step_plain",)}


@contextlib.contextmanager
def twin_calls(twins=TWINS):
    """Within the block every call of a plain twin of the training kernels
    (``TWINS``; the beam's are ``SERVING_TWINS``) is counted, by name, in
    the dict it yields."""
    import importlib

    mods = {m: importlib.import_module(f"avsr_tpu_torch.ops.kernels.{m}")
            for m in twins}
    calls = {name: 0 for names in twins.values() for name in names}
    originals = {(m, name): getattr(mods[m], name)
                 for m, names in twins.items() for name in names}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for (m, name), fn in originals.items():
        setattr(mods[m], name, counted(name, fn))
    try:
        yield calls
    finally:
        for (m, name), fn in originals.items():
            setattr(mods[m], name, fn)


def watched_params(model) -> dict:
    """Copies of the stem's convolution, the first layer's query weight
    and the decoder's output layer: training must change each."""
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.endswith(("frontend3D.0.weight",
                           "layers.0.attention.q_proj.weight",
                           "output_layer.weight"))}


def phase_training(dev, smi: str, fused_stem: bool = False):
    """Full-width bf16 training through bench_train at its defaults:
    its 2 warm-up steps, then 5 timed ones between which it sets the
    kernels' counts to 0 and reads them: 24 a step for each flash kernel,
    and with ``fused_stem`` (AVSR_FUSED_STEM=1) one a step for each of the
    four stem-tail kernels, none without. Returns the timed run's launches
    of each kernel and its record."""
    from avsr_tpu_torch.tools import bench_train

    args = bench_train.parse_args(["--steps", "5"])
    if fused_stem:
        os.environ["AVSR_FUSED_STEM"] = "1"
    state, batch = bench_train.setup(args)
    layers = state.model.cfg.encoder.num_hidden_layers
    watched = watched_params(state.model)
    try:
        with twin_calls() as calls, stem_layouts() as seen:
            res = bench_train.measure(state, batch, args)
    finally:
        os.environ.pop("AVSR_FUSED_STEM", None)
    per_step = res["launches_per_step"]
    what = " (AVSR_FUSED_STEM=1)" if fused_stem else ""
    print(f"# {smi}: train step{what} {res['sec_per_step'] * 1e3:.1f} ms -> "
          f"{res['samples_per_sec']:.2f} samples/s, {res['step_tflops']:.2f} "
          f"TFLOP a step, MFU {res['mfu']:.4f}, peak memory "
          f"{res['peak_mem_gb']:.2f} GB; loss {res['loss']:.4f}, grad_norm "
          f"{res['grad_norm']:.4f}; launches a step {per_step}; twin calls "
          f"{calls}")
    print("# bench_train " + json.dumps(res))
    check(np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"]),
          "training loss or gradient norm not finite")
    for name, before in watched.items():
        check(not torch.equal(before, dict(state.model.named_parameters())
                              [name].detach()),
              f"{name} did not change in training")
    # the flash kernels run every step; the stem's forward kernels once a
    # step with the switch, its backward in the steps that keep the video
    # (whole-batch modality dropout zeroes the video features of a step,
    # and with them the frontend's gradient)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        check(per_step[name] == layers,
              f"{name}: {per_step[name]} launches a step, not {layers}")
    fwd = per_step["bn_prelu_pool_stats"], per_step["bn_prelu_pool_apply"]
    bwd = per_step["bn_prelu_pool_bwd1"], per_step["bn_prelu_pool_bwd2"]
    if fused_stem:
        check(fwd == (1.0, 1.0) and bwd[0] == bwd[1] and 0 < bwd[0] <= 1,
              f"stem kernels: {fwd} forward and {bwd} backward launches a "
              f"step{what}")
        check(seen and all(seen), f"the stem's x was not channels-last in "
              f"training ({seen}), so the fused tail copied it")
    else:
        check(fwd + bwd == (0.0,) * 4, "stem kernels ran without the switch")
    check(not any(calls.values()), f"a plain twin ran on the card: {calls}")
    launches = {name: int(round(n * args.steps))
                for name, n in per_step.items()}
    return launches, res


def phase_train_parity(dev, fused_stem: bool = False):
    """One fp32 train_step of the same full-width weights on the card
    (kernels) and on the CPU (twins): B=2, T=32 with the second utterance
    25 frames, 12 and 9 labels, every dropout off. Losses within 1e-4
    relative; gradient norms before clipping, global and per module,
    within 1e-3, the video frontend's within 2e-2 (fp32 conditioning of
    its gradient, ROADMAP C16). With ``fused_stem`` both sides run the
    stem tail as bn_prelu_pool (AVSR_FUSED_STEM=1)."""
    from avsr_tpu_torch.core.config import AVHubertAVSRConfig
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.data.synthetic import synthetic_train_batch
    from avsr_tpu_torch.models.e2e import AVSRModel
    from avsr_tpu_torch.train import trainer as T

    cfg = AVHubertAVSRConfig(dropout_rate=0.0,
                             transformer_attn_dropout_rate=0.0)
    e = cfg.encoder
    e.hidden_dropout = e.attention_dropout = e.activation_dropout = 0.0
    e.dropout_input = e.modality_dropout = 0.0
    cpu_model = AVSRModel(cfg)
    init_weights(cpu_model, torch.Generator().manual_seed(2))
    batch = synthetic_train_batch(np.random.RandomState(2), 2, 32, 12,
                                  video_lengths=[32, 25],
                                  label_lengths=[12, 9],
                                  vocab=min(5000, cfg.odim - 1))

    def group(name):  # the video frontend, its projection, the audio
        # projection, the fusion, the transformer, the CTC head, the decoder
        parts = name.split(".")
        if parts[0] != "encoder":
            return parts[0]
        if parts[1].startswith("feature_extractor"):
            return ".".join(parts[1:3])
        return "transformer" if parts[1] == "encoder" else "fusion"

    out = {}
    if fused_stem:
        os.environ["AVSR_FUSED_STEM"] = "1"
    for where in (dev, "cpu"):
        model = copy.deepcopy(cpu_model)
        state = T.init_state(cfg, T.TrainConfig(), device=where, model=model)
        t0 = time.perf_counter()
        m = {k: v.item() for k, v in
             T.train_step(state, T.to_device(batch, where)).items()}
        # train_step clipped the gradients in place: undo its factor
        clip = max(m["grad_norm"] / state.cfg.max_grad_norm, 1.0)
        sq = {}
        for name, p in state.model.named_parameters():
            sq[group(name)] = sq.get(group(name), 0.0) + float(
                p.grad.double().pow(2).sum())
        out[str(where)] = (m, {k: v ** 0.5 * clip for k, v in sq.items()})
        print(f"# train_step on {where}: {time.perf_counter() - t0:.1f} s")
    os.environ.pop("AVSR_FUSED_STEM", None)
    what = " (AVSR_FUSED_STEM=1)" if fused_stem else ""
    (cm, cn), (pm, pn) = out[str(dev)], out["cpu"]
    for k in ("loss", "loss_ctc", "loss_att", "grad_norm"):
        rel = abs(cm[k] - pm[k]) / abs(pm[k])
        lim = 1e-3 if k == "grad_norm" else 1e-4
        print(f"# train parity{what} {k}: cuda {cm[k]:.6f} cpu {pm[k]:.6f} "
              f"rel_err {rel:.2e} (limit {lim:g})")
        check(rel <= lim, f"train parity: {k} cuda vs cpu")
    check(cm["acc"] == pm["acc"], "train parity: accuracy cuda vs cpu")
    for k in sorted(pn):
        rel = abs(cn[k] - pn[k]) / pn[k]
        lim = 2e-2 if k == "feature_extractor_video.resnet" else 1e-3
        print(f"# train parity{what} |grad| {k}: {rel:.2e} (limit "
              f"{lim:g})")
        check(rel <= lim, f"train parity: gradient norm of {k}")


EVAL_UTTERANCES = 32  # the CLI's batch: one chunk of the producer
EVAL_WINDOWS = 3  # timed passes of phase 8 after the warm one
EVAL_SECONDS = (2.0, 15.0)  # the range the utterances' durations span
EVAL_WORDS = ("HELLO", "WORLD", "THE", "LAZY", "DOG", "QUICK", "BROWN",
              "FOX", "SPEECH", "VIDEO", "AUDIO", "TEST")


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:  # length-delimited
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def write_toy_tokenizer(directory: str, units: int) -> None:
    """A SentencePiece model proto (field 1: pieces of piece=1, score=2
    as a 32-bit float, type=3) holding <unk>, <s>, </s> and EVAL_WORDS,
    and a units file of exactly ``units`` lines (<unk> 1, the words, then
    filler pieces), so that every id below units + 2 maps to a piece."""
    import struct

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)] + [
        ("\u2581" + w, -1.0 - i, 1) for i, w in enumerate(EVAL_WORDS)]
    proto = b"".join(_field(1, _field(1, p.encode()) + _varint(2 << 3 | 5)
                            + struct.pack("<f", sc)
                            + (_varint(3 << 3) + _varint(t) if t != 1 else b""))
                     for p, sc, t in pieces)
    with open(os.path.join(directory, "unigram5000.model"), "wb") as f:
        f.write(proto)
    names = [p for p, _, t in pieces if t == 1]
    names += [f"\u2581W{i}" for i in range(units - 1 - len(names))]
    with open(os.path.join(directory, "unigram5000_units.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(["<unk> 1"] + [f"{p} {i + 2}" for i, p in
                                         enumerate(names)]) + "\n")


def write_reference_dir(ckpt: str, cfg, dev) -> str:
    """A reference-format checkpoint directory of ``cfg``'s model with
    seed-0 weights: config.json and pytorch_model.bin (``avsr.`` keys)."""
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.models.e2e import AVSRModel

    os.makedirs(ckpt)
    cfg.to_json(os.path.join(ckpt, "config.json"))
    with torch.device(dev):
        model = AVSRModel(cfg)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    torch.save({f"avsr.{k}": v.cpu() for k, v in model.state_dict().items()},
               os.path.join(ckpt, "pytorch_model.bin"))
    return ckpt


def check_mp4_writer(directory: str) -> None:
    """Phase 8 writes its utterances as mp4 with cv2 and the engine decodes
    them (pyav first, if present): fail where cv2 cannot write mp4."""
    try:
        import cv2
    except ImportError:
        check(False, "phase 8: cv2 does not import, so no mp4 is written")
    writer = cv2.VideoWriter(os.path.join(directory, "probe.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (96, 96))
    ok = writer.isOpened()
    writer.release()
    check(ok, "phase 8: cv2 cannot open an mp4 writer")


@contextlib.contextmanager
def twins_checked(seen: dict):
    """Within the block, every call the beam makes of ``topk_lastdim``,
    ``topk_gather_rows``, ``beam_update`` and ``decode_attention`` is also
    held against the twin
    on copies of the same card tensors, taken before the kernel writes:
    the top-k and every output of beam_update exact, decode_attention's
    cache bit-equal and its output within ``output_bound``. ``seen`` gets,
    per kernel path (the wide ones under ``<name>_wide``), the calls, the
    input shapes and the largest absolute error. The twins launch no
    kernel, so the launch counts are those of the run."""
    from avsr_tpu_torch.decode import beam as beam_mod
    from avsr_tpu_torch.models import decoder as decoder_mod
    from avsr_tpu_torch.ops.kernels import beam_update as pbu
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import row_gather as prg
    from avsr_tpu_torch.ops.kernels import topk as ptk

    def note(name, wide, shape, err):
        entry = seen.setdefault(f"{name}_wide" if wide else name,
                                {"calls": 0, "shapes": set(), "err": 0.0})
        entry["calls"] += 1
        entry["shapes"].add(shape)
        entry["err"] = max(entry["err"], err)

    def topk(x, k):
        got = ptk.topk_lastdim(x, k)
        want = ptk.topk_plain(x, k)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"topk_lastdim disagrees on the beam's {tuple(x.shape)} k={k}")
        note("topk_lastdim", k > ptk.MAX_K, (tuple(x.shape), k), 0.0)
        return got

    def topk_rows(x, k, table):
        got = ptk.topk_gather_rows(x, k, table)
        vals, ids = ptk.topk_plain(x, k)
        base = torch.arange(x.shape[0], device=x.device)[:, None, None]
        rows = prg.row_gather_plain(table, (ids + base * x.shape[2]).view(-1))
        check(torch.equal(got[0], vals) and torch.equal(got[1], ids)
              and torch.equal(got[2], rows),
              f"topk_gather_rows disagrees on the beam's {tuple(x.shape)} "
              f"k={k}, table {tuple(table.shape)}")
        note("topk_gather_rows", k > ptk.MAX_K,
             (tuple(x.shape), k, tuple(table.shape)), 0.0)
        return got

    def bookkeeping(i, *args, **kw):
        copies = [a.clone() if torch.is_tensor(a) else a for a in args]
        got = pbu.beam_update(i, *args, **kw)
        want = pbu.beam_update_plain(i, *copies, **kw)
        for name, w in want.items():
            check(torch.equal(got[name], w),
                  f"beam_update {name} disagrees on the beam's step {i}")
        dec_top, yseq = args[1], args[10]  # (B, K, S'), (B, K, L)
        b, k, sp = dec_top.shape
        note("beam_update", k > pbu.MAX_K or k * (sp + 1) > pbu.MAX_CAND,
             (b, k, sp, yseq.shape[-1]), 0.0)
        return got

    def attention(pos, q, kv, lb, lanes, heads, kv_row=None):
        before = kv.clone()
        got, got_kv = pda.decode_attention(pos, q, kv, lb, lanes, heads,
                                           kv_row=kv_row)
        want, want_kv = pda.decode_attention_plain(
            pos, q, before.clone(), lb, lanes, heads, kv_row)
        bnd = pda.output_bound(pos, q, before, lb, lanes, heads, kv_row)
        diff = (got.float() - want.float()).abs()
        check(torch.equal(got_kv, want_kv) and bool((diff <= bnd).all()),
              f"decode_attention disagrees on the beam's step {pos}, "
              f"{lanes} lanes, cache {tuple(kv.shape)}")
        note("decode_attention", lanes > pda.MAX_LANES,
             (tuple(kv.shape), lanes), diff.max().item())
        return got, got_kv

    saved = (beam_mod.topk_lastdim, beam_mod.topk_gather_rows,
             beam_mod.beam_update, decoder_mod.decode_attention)
    beam_mod.topk_lastdim, beam_mod.topk_gather_rows = topk, topk_rows
    beam_mod.beam_update = bookkeeping
    decoder_mod.decode_attention = attention
    try:
        yield seen
    finally:
        (beam_mod.topk_lastdim, beam_mod.topk_gather_rows,
         beam_mod.beam_update, decoder_mod.decode_attention) = saved


@contextlib.contextmanager
def layer_checked(seen: dict):
    """Within the block, every call the decoder makes of
    ``decoder_layer_step`` is also held against its twin on copies of the
    same card tensors, taken before the kernel writes: x_out and the
    written row within 2e-2 of their largest entry (as phase 3 holds B9),
    every other cache row untouched. ``seen["decoder_layer_step"]`` gets
    the calls, the input shapes and the largest absolute error of x_out.
    The twin launches no kernel."""
    from avsr_tpu_torch.models import decoder as decoder_mod
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl

    real = decoder_mod.decoder_layer_step

    def layer(pos, x, kv, src_k, src_v, mem_bias, lane_bias, packed, lanes,
              heads, scratch=None):
        before = kv.clone()
        got, got_kv = real(pos, x, kv, src_k, src_v, mem_bias, lane_bias,
                           packed, lanes, heads, scratch=scratch)
        want, want_kv = pdl.decoder_layer_step_plain(
            pos, x, before, src_k, src_v, mem_bias, lane_bias, packed, lanes,
            heads)
        row = min(pos, kv.shape[1] - 1)
        rest = torch.arange(kv.shape[1], device=kv.device) != row
        e_x, e_row = _rel_err(got, want), _rel_err(got_kv[:, row],
                                                   want_kv[:, row])
        check(e_x <= 2e-2 and e_row <= 2e-2
              and torch.equal(got_kv[:, rest], want_kv[:, rest]),
              f"decoder_layer_step disagrees on the beam's step {pos}, "
              f"{lanes} lanes: x_out {e_x:.2e}, row {e_row:.2e}")
        entry = seen.setdefault("decoder_layer_step",
                                {"calls": 0, "shapes": set(), "err": 0.0})
        entry["calls"] += 1
        entry["shapes"].add((tuple(kv.shape), lanes))
        entry["err"] = max(entry["err"],
                           (got.float() - want.float()).abs().max().item())
        return got, got_kv

    decoder_mod.decoder_layer_step = layer
    try:
        yield seen
    finally:
        decoder_mod.decoder_layer_step = real


def phase_eval(dev, smi: str):
    """The evaluation entry point at full width: ``avsr_tpu_torch.cli.
    evaluation.InferenceEngine`` at the CLI's defaults (beam 3, 32 segments
    a batch, bf16 decoder weights and K|V cache, fp32 encoder, on the card)
    on the flagship configuration, loaded from a reference-format directory
    (config.json, pytorch_model.bin of seed-0 random weights) through
    ``load_released``, with a toy tokenizer found through AVSR_SPM_DIR.
    32 utterances of 2-15 s (seeded): smooth 96x96 crops, a 16 kHz
    waveform and a label of random words, as mp4 + wav bytes (written with
    cv2) through ``eval_lrs2``: one untimed pass (the native fbank's build,
    the first B=32 encode and beam), then ``EVAL_WINDOWS`` timed ones, the
    median printed. Checks: every pass gives the same tokens, which are
    ``Recognizer.transcribe_batch``'s on the same collated features, the
    WER is finite, and the serving kernels ran. Then beams of 22 and of 10
    through the engine on two 3 s utterances, unfused and fused: none
    raises, fused and unfused give the same tokens, and the C28 kernels
    ran; the same runs again under ``twins_checked``, every kernel call
    held against its twin. Returns the launch counts of each run and what
    the checked runs saw."""
    import tempfile

    from avsr_tpu_torch.core.config import AVHubertAVSRConfig
    from avsr_tpu_torch.data.synthetic import smooth_crops
    from avsr_tpu_torch.ops import fbank
    from avsr_tpu_torch.ops.kernels import beam_update as pbu
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa
    from avsr_tpu_torch.ops.kernels import row_gather as prg
    from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl
    from avsr_tpu_torch.ops.kernels import topk as ptk

    counters = (pfa.flash_attention_fwd, pda.decode_attention,
                ptk.topk_lastdim, ptk.topk_gather_rows, prg.row_gather,
                psl.cumlogsumexp, pbu.beam_update)

    def reset():
        for fn in counters:
            fn.launches = 0
        ptk.topk_lastdim.flat_launches = ptk.topk_lastdim.wide_launches = 0
        pbu.beam_update.wide_launches = 0
        pda.decode_attention.wide_launches = 0

    def counts():
        """Each kernel's launches, the wide paths apart from the others."""
        n = {fn.__name__: fn.launches for fn in counters}
        n["topk_lastdim_flat"] = ptk.topk_lastdim.flat_launches
        for fn in (ptk.topk_lastdim, pbu.beam_update, pda.decode_attention):
            n[f"{fn.__name__}_wide"] = fn.wide_launches
            n[fn.__name__] -= fn.wide_launches
        n["topk_lastdim"] -= n["topk_lastdim_flat"]
        return n

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as root:
        cfg = AVHubertAVSRConfig()
        os.environ["AVSR_SPM_DIR"] = os.path.join(root, "spm")
        os.makedirs(os.environ["AVSR_SPM_DIR"])
        write_toy_tokenizer(os.environ["AVSR_SPM_DIR"], cfg.odim - 2)
        from avsr_tpu_torch.cli import evaluation as pe
        from avsr_tpu_torch.data import media, tokenizer

        check(tokenizer._DEFAULT_ASSET_DIRS[0] == os.environ["AVSR_SPM_DIR"],
              "the tokenizer was imported before AVSR_SPM_DIR was set")
        ckpt = write_reference_dir(os.path.join(root, "ckpt"), cfg, dev)
        t0 = time.perf_counter()
        engine = pe.InferenceEngine(checkpoint_path=ckpt)
        engine.load_model()
        rec = engine.recognizer
        print(f"# engine loaded in {time.perf_counter() - t0:.1f} s")
        check(engine.device == "cuda" and rec.device.type == "cuda"
              and (rec.beam_size, engine.batch_size) == (3, 32)
              and rec.cfg.decoder_param_dtype == "bfloat16"
              and rec.cfg.decoder_cache_dtype == "bfloat16"
              and rec.encode_dtype == "float32"
              and not rec.fused_bookkeeping,
              "the engine is not at the CLI's defaults")

        rng = np.random.RandomState(0)
        frames = np.round(rng.uniform(*EVAL_SECONDS, EVAL_UTTERANCES)
                          * 25).astype(int)
        utts = [(smooth_crops(rng, n, 96)[..., 0],
                 (0.1 * rng.randn(n * 640)).astype(np.float32),
                 " ".join(rng.choice(EVAL_WORDS, rng.randint(2, 12))))
                for n in frames]
        audio_s = float(frames.sum()) / 25.0
        check_mp4_writer(root)

        def samples_of(utts, name):
            out = []
            for i, (v, a, label) in enumerate(utts):
                path = os.path.join(root, f"{name}{i}.mp4")
                media.save_video(path, v)
                media.save_audio(path[:-4] + ".wav", a)
                with open(path, "rb") as f, open(path[:-4] + ".wav",
                                                 "rb") as g:
                    out.append({"video": f.read(), "audio": g.read(),
                                "label": label})
            return out

        samples = samples_of(utts, "utt")
        # the engine's tokens, as it detokenizes them, in order
        tokens = []
        post = engine._decode_tokens

        def decode_tokens(toks):
            tokens.append(np.array(toks))
            return post(toks)

        engine._decode_tokens = decode_tokens
        route = fbank.fbank_route()  # builds the native fbank
        passes, walls = [], []
        for window in range(EVAL_WINDOWS + 1):  # the first is the warm-up
            del tokens[:]
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            score = pe.eval_lrs2(engine, samples)
            wall = time.perf_counter() - t0
            main = counts()
            passes.append(list(tokens))
            if window:
                walls.append(wall)
        wall = statistics.median(walls)
        print(f"# {smi}: phase 8 (mp4 route, fbank {route}): "
              f"{EVAL_UTTERANCES} utterances, {audio_s:.2f} audio-s; "
              f"wall of {EVAL_WINDOWS} passes after a warm one "
              f"{', '.join(f'{w:.3f}' for w in walls)} s (media decode, "
              f"fbank and collation included; not the engine's load or the "
              f"native fbank's build) -> median {audio_s / wall:.2f} "
              f"audio-s/s ({audio_s / max(walls):.2f}-"
              f"{audio_s / min(walls):.2f}); WER {score:.4f}; launches "
              f"of the last pass {main}")
        check(len(tokens) == EVAL_UTTERANCES, "phase 8: transcripts missing")
        check(all(len(p) == len(tokens) and all(
            np.array_equal(a, b) for a, b in zip(p, tokens)) for p in passes),
            "phase 8: the passes' tokens differ")
        check(math.isfinite(score), "phase 8: WER is not finite")
        steps = main["decode_attention"] // cfg.dlayers
        check(steps >= 1 and main["flash_attention_fwd"]
              >= cfg.encoder.num_hidden_layers
              and main["topk_lastdim"] >= steps
              and main["topk_lastdim_flat"] >= steps
              and main["topk_gather_rows"] >= steps
              and main["row_gather"] == 0
              and main["cumlogsumexp"] >= 2 * steps
              and main["beam_update"] == 0
              and main["decode_attention_wide"] == 0,
              f"phase 8: the serving kernels did not run as the beam "
              f"does ({main})")

        # the same collated features through Recognizer.transcribe_batch
        feats = engine._features(samples)
        auds = [np.asarray(a)[:n] for a, _, n in feats]
        vids = [np.asarray(v)[:n] for _, v, n in feats]
        want = rec.transcribe_batch(auds, vids, batch_pad=engine.batch_size)
        check(len(want) == len(tokens) and all(
            np.array_equal(w, t) for w, t in zip(want, tokens)),
            "phase 8: the engine's tokens are not transcribe_batch's")

        # beams of 22 and 10 on two 3 s utterances, unfused and fused;
        # then again with every kernel call held against its twin
        short = [{k: v for k, v in x.items() if k != "label"}
                 for x in samples_of([
                     (smooth_crops(rng, 75, 96)[..., 0],
                      (0.1 * rng.randn(75 * 640)).astype(np.float32),
                      "HELLO WORLD") for _ in range(2)], "short")]
        runs, seen, run_tokens = {}, {}, {}
        for checked in (False, True):
            for beam in (22, 10):
                got = {}
                for fused in (False, True):
                    rec.beam_size, rec.fused_bookkeeping = beam, fused
                    del tokens[:]
                    torch.cuda.synchronize()
                    reset()
                    t0 = time.perf_counter()
                    with (twins_checked(seen) if checked
                          else contextlib.nullcontext()):
                        out = engine.infer_samples(short)
                    torch.cuda.synchronize()
                    name = f"beam {beam}{' fused' if fused else ''}"
                    got[fused] = list(tokens)
                    check(len(out) == 2, f"{name}: transcripts missing")
                    if checked:
                        check(all(np.array_equal(a, b) for a, b in
                                  zip(got[fused], run_tokens[name])),
                              f"{name}: the checked run's tokens differ")
                        continue
                    runs[name], run_tokens[name] = counts(), got[fused]
                    print(f"# {name}: 2 x 3 s in "
                          f"{time.perf_counter() - t0:.3f} s; launches "
                          f"{runs[name]}")
                check(all(np.array_equal(a, b)
                          for a, b in zip(got[False], got[True])),
                      f"beam {beam}: fused and unfused tokens differ")
        # the same beams a third way: the decoder's fused layer
        # (decode_fused_layer) on the same seed-0 weights, every
        # decoder_layer_step call held against its twin (ROADMAP C30)
        rec.model.decoder.fused_layer = True
        try:
            for beam in (22, 10):
                rec.beam_size, rec.fused_bookkeeping = beam, False
                del tokens[:]
                torch.cuda.synchronize()
                reset()
                pdl.decoder_layer_step.launches = 0
                t0 = time.perf_counter()
                with layer_checked(seen):
                    out = engine.infer_samples(short)
                torch.cuda.synchronize()
                name = f"beam {beam} fused layer"
                runs[name] = counts()
                runs[name]["decoder_layer_step"] = (
                    pdl.decoder_layer_step.launches)
                same = all(np.array_equal(a, b) for a, b in
                           zip(tokens, run_tokens[f"beam {beam}"]))
                print(f"# {name}: 2 x 3 s in {time.perf_counter() - t0:.3f} "
                      f"s, every layer step checked; tokens equal to the "
                      f"unfused layer's: {same}; launches {runs[name]}")
                n = runs[name]
                check(len(out) == 2 and n["decoder_layer_step"] >= cfg.dlayers
                      and n["decoder_layer_step"] % cfg.dlayers == 0
                      and n["decode_attention"] == 0
                      and n["decode_attention_wide"] == 0,
                      f"{name}: decoder_layer_step not launched once per "
                      f"layer and step ({n})")
        finally:
            rec.model.decoder.fused_layer = False
        rec.beam_size, rec.fused_bookkeeping = 3, False
        for name, entry in sorted(seen.items()):
            print(f"# beams 22 and 10 checked against the twins: {name} "
                  f"{entry['calls']} calls, largest abs error "
                  f"{entry['err']:.3e}, inputs {sorted(entry['shapes'])}")
        check(runs["beam 22"]["topk_lastdim_wide"] >= 1
              and runs["beam 22 fused"]["beam_update_wide"] >= 1
              and runs["beam 10 fused"]["beam_update_wide"] >= 1
              and runs["beam 10"]["topk_lastdim_wide"] == 0
              and runs["beam 22"]["beam_update"] == 0
              and runs["beam 22"]["beam_update_wide"] == 0
              and all(n["decode_attention_wide"] >= 1
                      and n["decode_attention"] == 0 for name, n in
                      runs.items() if "fused layer" not in name),
              "phase 8: the C28 kernels did not run where they should")
        check(all(f"{n}_wide" in seen for n in (
            "topk_gather_rows", "beam_update", "decode_attention"))
            and "topk_lastdim" in seen and "decoder_layer_step" in seen,
            "phase 8: a wide path was not checked against its twin")
        del os.environ["AVSR_SPM_DIR"]
    runs["eval"] = main
    return runs, seen

TRAIN_CLI_ARGS = ["--synthetic_dataset", "--batch_size", "6",
                  "--gradient_accumulation_steps", "2", "--save_steps", "3",
                  "--eval_steps", "3", "--log_interval", "1",
                  "--warmup_steps", "2", "--save_total_limit", "1",
                  "--dataloader_num_workers", "4"]
SYNC_STEPS = (3, 5)  # the steps watched by torch.cuda.set_sync_debug_mode


@contextlib.contextmanager
def loop_spy(sync_steps=None):
    """Within the block, records what ``train/loop.run_training`` does:
    ``train`` holds (state.step at entry, micro-batches) a train step,
    ``evals`` counts eval steps, ``logs`` holds (prefix, step, metrics,
    host time) a log line. With ``sync_steps`` (first, last), every call
    that synchronises with the host is recorded in ``syncs`` from the
    start of step ``first`` up to the metrics fetch after step ``last``
    (``torch.cuda.set_sync_debug_mode("warn")``), as the innermost frame
    of the port that made it (file:line) and the torch frame that warned.
    """
    import traceback
    import warnings

    from avsr_tpu_torch.train import loop, trainer

    rec = {"train": [], "evals": 0, "logs": [], "syncs": []}
    real = (trainer.train_step, trainer.eval_step, loop.MetricsLogger.log,
            loop._fetch_mean)
    watch = {}

    def stop_watch():
        if "cm" in watch:
            torch.cuda.set_sync_debug_mode(0)
            watch.pop("cm").__exit__(None, None, None)

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        ours = [f for f in traceback.extract_stack()[:-1]
                if "/avsr_tpu_torch/" in f.filename
                or f.filename.endswith("chip_smoke.py")]
        where = "outside the port"
        if ours and ours[-1].filename.endswith("chip_smoke.py"):
            where = f"chip_smoke.py:{ours[-1].lineno} (the watch itself)"
        elif ours:
            where = (f"{ours[-1].filename.split('/avsr_tpu_torch/')[-1]}:"
                     f"{ours[-1].lineno}")
        rec["syncs"].append((where, f"{os.path.basename(filename)}:{lineno}"))

    def train_step(state, batch):
        if sync_steps and state.step + 1 == sync_steps[0]:
            watch["cm"] = warnings.catch_warnings()
            watch["cm"].__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            torch.cuda.set_sync_debug_mode("warn")
        v = batch["videos"]
        rec["train"].append((state.step, v.shape[0] if v.dim() > 5 else 1))
        return real[0](state, batch)

    def eval_step(state, batch):
        rec["evals"] += 1
        return real[1](state, batch)

    def log(self, step, metrics, prefix="train"):
        rec["logs"].append((prefix, step, dict(metrics), time.perf_counter()))
        return real[2](self, step, metrics, prefix)

    def fetch_mean(window):
        stop_watch()
        return real[3](window)

    trainer.train_step, trainer.eval_step = train_step, eval_step
    loop.MetricsLogger.log, loop._fetch_mean = log, fetch_mean
    try:
        yield rec
    finally:
        stop_watch()
        (trainer.train_step, trainer.eval_step, loop.MetricsLogger.log,
         loop._fetch_mean) = real


def _train_logs(rec) -> dict:
    return {step: m for prefix, step, m, _ in rec["logs"] if prefix == "train"}


def phase_remat(dev, smi: str):
    """One bf16 forward and backward of the flagship at bench_train's
    shape (B=6, T=384, the config's dropouts) from one state and one
    batch, four ways: no remat, no remat again (the card's run-to-run
    floor), ``scan_remat=full``, and ``full`` with ``frontend_remat``.
    The losses and the BN running statistics must be bit-equal (the same
    forward kernels on the same inputs, the same dropout draws replayed).
    The card's backward is not deterministic (weight-gradient kernels that
    sum with atomics: the two no-remat runs differ), so each remat
    gradient must lie within twice that floor of the no-remat one, tensor
    by tensor, plus 1e-2 of its largest entry (2.5 bf16 ulps); the
    measured differences are printed. Peak memory above the start of the
    step: ``full`` must be below no remat."""
    import gc

    from avsr_tpu_torch.ops.kernels import flash_attention as pfa
    from avsr_tpu_torch.tools import bench_train
    from avsr_tpu_torch.train import trainer as T

    state, batch = bench_train.setup(bench_train.parse_args(["--batch", "6"]))
    model, enc = state.model, state.model.cfg.encoder
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rng0 = state.rng.state()
    runs = {}
    for name, mode, front in (("none", "none", False),
                              ("none again", "none", False),
                              ("full", "full", False),
                              ("full + frontend", "full", True)):
        model.load_state_dict(start)
        state.rng.load_state(rng0)
        model.zero_grad(set_to_none=True)
        enc.scan_remat, enc.frontend_remat = mode, front
        pfa.flash_attention_fwd.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = T.loss_fn(model, batch, state.rng, True, "bfloat16")
        loss.backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        # (the whole-batch modality dropout may leave a branch without
        # a gradient; the same draw in every run)
        runs[name] = (loss.detach().clone(),
                      {n: p.grad.detach().clone()
                       for n, p in model.named_parameters()
                       if p.grad is not None},
                      {n: b.clone() for n, b in model.named_buffers()}, peak)
        print(f"# {smi}: remat {name}: loss {loss.item():.6f}, forward and "
              f"backward {ms:.1f} ms, peak memory above the state "
              f"{peak:.2f} GB, flash forward launches "
              f"{pfa.flash_attention_fwd.launches}")
    enc.scan_remat, enc.frontend_remat = "none", False
    loss0, grads0, bufs0, peak0 = runs["none"]
    floor = {n: (runs["none again"][1][n] - g).abs().max().item()
             for n, g in grads0.items()}
    for name in ("none again", "full", "full + frontend"):
        loss, grads, bufs, peak = runs[name]
        check(set(grads) == set(grads0),
              f"remat {name}: other parameters have gradients")
        err = {n: ((grads[n] - g).abs().max().item(),
                   g.abs().max().item()) for n, g in grads0.items()}
        worst = max(err, key=lambda n: err[n][0] / max(err[n][1], 1e-30))
        over = [n for n, (e, top) in err.items()
                if e > 2 * floor[n] + 1e-2 * top]
        print(f"# remat {name} vs none: loss equal {torch.equal(loss, loss0)}"
              f", largest gradient difference {err[worst][0]:.3e} = "
              f"{err[worst][0] / max(err[worst][1], 1e-30):.3e} of the "
              f"largest entry of {worst} (the no-remat runs' floor there "
              f"{floor[worst]:.3e}); over the limit: {over}; BN statistics "
              f"equal {all(torch.equal(bufs[n], b) for n, b in bufs0.items())}")
        check(torch.equal(loss, loss0), f"remat {name}: the loss differs")
        check(all(torch.equal(bufs[n], b) for n, b in bufs0.items()),
              f"remat {name}: the BN running statistics differ")
        check(not over, f"remat {name}: gradients of {over} differ")
    check(runs["full"][3] < peak0, "remat full does not lower peak memory")
    del state, batch, model, runs, start
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_cli(dev, smi: str):
    """The training entry point at full width: ``cli/train.main`` on the
    flagship configuration (24x1024 encoder, ResNet-18, 6x1024 decoder,
    bf16 compute over fp32 masters), loaded from a reference-format
    directory of seed-0 weights with the toy tokenizer, into a temporary
    output directory deleted at the end:

    1. fine-tuning at the JAX CLI's batch defaults (``TRAIN_CLI_ARGS``,
       6 steps): 6 steps of 2 micro-batches, finite losses and gradient
       norms, the watched parameters changed, 24 launches of each flash
       kernel a micro-batch (the forward also per eval batch), no plain
       twin called, only ``checkpoints/6`` left, ``best.json`` written;
       prints the loop's wall samples/s over steps 2-6 (collation, the
       step-3 eval and the save's queueing included) and peak memory;
    2. the same command to 8 steps with ``--resume_from_checkpoint``:
       starts at step 6, ends at 8;
    3. remat at full width (``phase_remat``);
    4. ``--pretrain`` for 3 steps from seed-0 random weights: finite
       losses, the five metrics;
    5. ``AVSR_FUSED_STEM=1`` for 2 steps: the stem kernels launch as in
       phase 6, on channels-last frames;
    6. 5 steps with a log at step 5 only, every host sync of steps 3-5
       recorded (``loop_spy``): none may come from the loop's code."""
    import gc
    import tempfile

    from avsr_tpu_torch.cli import train as cli
    from avsr_tpu_torch.core.config import AVHubertAVSRConfig
    from avsr_tpu_torch.data import tokenizer
    from avsr_tpu_torch.ops.kernels import flash_attention as pfa
    from avsr_tpu_torch.ops.kernels import stem_fuse as psf
    from avsr_tpu_torch.train.pretrain import METRICS

    flash = (pfa.flash_attention_fwd, pfa.flash_attention_bwd_dq,
             pfa.flash_attention_bwd_dkv)
    stem = (psf.bn_prelu_pool_stats, psf.bn_prelu_pool_apply,
            psf.bn_prelu_pool_bwd1, psf.bn_prelu_pool_bwd2)
    assets = tokenizer._DEFAULT_ASSET_DIRS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        cfg = AVHubertAVSRConfig()
        spm = os.path.join(root, "spm")
        os.makedirs(spm)
        write_toy_tokenizer(spm, cfg.odim - 2)
        tokenizer._DEFAULT_ASSET_DIRS = (spm,)
        ckpt = write_reference_dir(os.path.join(root, "ckpt"), cfg, dev)
        layers = cfg.encoder.num_hidden_layers

        def run(out, extra, **spy):
            for fn in flash + stem:
                fn.launches = 0
            argv = (TRAIN_CLI_ARGS + ["--model_name_or_path", ckpt,
                                      "--output_dir", os.path.join(root, out)]
                    + extra)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with loop_spy(**spy) as rec, twin_calls() as calls, \
                    stem_layouts() as seen:
                state = cli.main(argv)
            torch.cuda.synchronize()
            rec.update(wall=time.perf_counter() - t0, twins=calls,
                       seen=seen, peak=torch.cuda.max_memory_allocated() / 1e9,
                       launches={fn.__name__: fn.launches
                                 for fn in flash + stem})
            return state, rec

        try:
            # 1. fine-tuning, 6 steps
            state, rec = run("ft", ["--max_steps", "6"])
            watched = watched_params(state.model)
            logs = _train_logs(rec)
            micro = sum(n for _, n in rec["train"])
            times = {step: t for p, step, _, t in rec["logs"]
                     if p == "train"}
            eval3 = [t for p, step, _, t in rec["logs"]
                     if p == "eval" and step == 3][0] - times[3]
            sps = 5 * 12 / (times[6] - times[1])
            print(f"# {smi}: phase 9 fine-tuning, 6 steps of 2 x 6 clips: "
                  f"{rec['wall']:.1f} s in main (model load, 2 evals, 2 "
                  f"saves); loop wall over steps 2-6 {times[6] - times[1]:.3f}"
                  f" s -> {sps:.2f} samples/s (collation, the step-3 eval "
                  f"of {eval3:.3f} s and the save's queueing included; "
                  f"{5 * 12 / (times[6] - times[1] - eval3):.2f} samples/s "
                  f"without the eval); peak memory {rec['peak']:.2f} GB; "
                  f"launches {rec['launches']}; twin calls {rec['twins']}")
            for step, m in sorted(logs.items()):
                print(f"#   step {step}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in m.items()))
            check(state.step == 6 and sorted(logs) == [1, 2, 3, 4, 5, 6]
                  and [n for _, n in rec["train"]] == [2] * 6,
                  f"phase 9: not 6 steps of 2 micro-batches ({rec['train']})")
            check(all(math.isfinite(m["loss"]) and math.isfinite(
                m["grad_norm"]) for m in logs.values()),
                "phase 9: a loss or gradient norm is not finite")
            start = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                               weights_only=True)
            for name, p in watched.items():
                check(not torch.equal(start["avsr." + name], p.cpu()),
                      f"phase 9: {name} did not change")
            n = rec["launches"]
            check(n["flash_attention_fwd"] == layers * (micro + rec["evals"])
                  and n["flash_attention_bwd_dq"] == layers * micro
                  and n["flash_attention_bwd_dkv"] == layers * micro,
                  f"phase 9: flash launches {n} for {micro} micro-batches "
                  f"and {rec['evals']} eval batches")
            check(not any(rec["twins"].values()),
                  f"phase 9: a plain twin ran ({rec['twins']})")
            ck = os.path.join(root, "ft", "avsr_avhubert_ctcattn",
                              "checkpoints")
            check(sorted(os.listdir(ck)) == ["6", "best.json"],
                  f"phase 9: checkpoints left {sorted(os.listdir(ck))}")
            with open(os.path.join(ck, "best.json")) as f:
                best = json.load(f)
            check(best["step"] in (3, 6) and math.isfinite(best["loss"]),
                  f"phase 9: best.json {best}")
            del state, watched, start
            gc.collect()

            # 2. resume to step 8
            state, rec = run("ft", ["--max_steps", "8",
                                    "--resume_from_checkpoint"])
            print(f"# phase 9 resume: steps {[s for s, _ in rec['train']]}"
                  f" at entry, ended at {state.step}, {rec['wall']:.1f} s")
            check([s for s, _ in rec["train"]] == [6, 7] and state.step == 8,
                  "phase 9: the resumed run did not go from step 6 to 8")
            del state
            gc.collect()
            torch.cuda.empty_cache()

            # 3. remat at full width
            phase_remat(dev, smi)

            # 4. pretraining, 3 steps, from seed-0 random weights
            state, rec = run("pt", ["--max_steps", "3", "--pretrain",
                                    "--model_name_or_path", ""])
            logs = _train_logs(rec)
            for step, m in sorted(logs.items()):
                print(f"# phase 9 pretrain step {step}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in m.items()))
            check(state.step == 3 and sorted(logs) == [1, 2, 3]
                  and all(set(m) == set(METRICS) | {"grad_norm"}
                          and all(math.isfinite(v) for v in m.values())
                          for m in logs.values()),
                  "phase 9: pretraining did not log 3 finite steps of its "
                  "five metrics")
            del state
            gc.collect()

            # 5. the fused stem tail, 2 steps
            os.environ["AVSR_FUSED_STEM"] = "1"
            try:
                state, rec = run("stem", ["--max_steps", "2"])
            finally:
                os.environ.pop("AVSR_FUSED_STEM", None)
            n, micro = rec["launches"], sum(k for _, k in rec["train"])
            print(f"# phase 9 AVSR_FUSED_STEM=1: {micro} micro-batches, "
                  f"launches {n}, stem x channels-last {set(rec['seen'])}")
            fwd = n["bn_prelu_pool_stats"], n["bn_prelu_pool_apply"]
            bwd = n["bn_prelu_pool_bwd1"], n["bn_prelu_pool_bwd2"]
            check(fwd == (micro, micro) and bwd[0] == bwd[1]
                  and 0 < bwd[0] <= micro and rec["seen"]
                  and all(rec["seen"]) and not any(rec["twins"].values()),
                  f"phase 9: stem kernels {n} with AVSR_FUSED_STEM=1")
            del state
            gc.collect()

            # 6. host syncs between two log steps
            extra = ["--max_steps", "5", "--log_interval", "5",
                     "--eval_steps", "100", "--save_steps", "100"]
            state, rec = run("sync", extra, sync_steps=SYNC_STEPS)
            where = {}
            for loc, torch_loc in rec["syncs"]:
                key = f"{loc} (torch {torch_loc})"
                where[key] = where.get(key, 0) + 1
            print(f"# phase 9 host syncs in steps {SYNC_STEPS[0]}-"
                  f"{SYNC_STEPS[1]} (no log between), by the port's frame "
                  f"that made them: {len(rec['syncs'])}: "
                  + (", ".join(f"{k} x{v}" for k, v in sorted(where.items()))
                     or "none"))
            check(not any(k.startswith(("train/loop.py", "cli/train.py"))
                          for k in where),
                  f"phase 9: the loop's own code synchronised: {where}")
            del state
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            tokenizer._DEFAULT_ASSET_DIRS = assets


AUTO_UTTERANCES = 8  # phase 10's eval_lrs2 utterances: one engine batch
AUTO_SHORT = (75, 60)  # (c)'s B=2 batch: 3 s and 2.4 s
AUTO_DIM, AUTO_HEADS = 768, 12  # the conformer decoder's width and heads
# (c)'s limits, phase 5's fp32 cuda-vs-cpu ones: CTC log-probs absolute,
# beam scores relative, and the encoder features relative to their largest
AUTO_CTC_TOL, AUTO_SCORE_TOL, AUTO_FEAT_TOL = 1e-3, 1e-4, 1e-3


def conformer_width_times(dev, g):
    """B2 and B9 at the conformer decoder's widths (C=768, 12 heads,
    F=3072, fp32 weights and K|V cache, as the auto_avsr path serves them)
    at B=8, beam 3, a 192-row cache, pos 250: one call each held against
    its twin (B2's cache bit-equal and output within ``output_bound``; B9's
    x_out and row within 1e-3 of their largest entry in fp32, 2e-2 in
    bf16), then timed cold (rotating over six layers') beside the twin,
    fused SDPA (B2) and the unfused layer step (B9). B9 also at C=768 in
    bf16 and at C=1024 (16 heads) in fp32, to place its fp32 time against
    phase 3's bf16 C=1024 one. Returns {name: (ms, twin ms, other ms,
    bound)} at the conformer's widths in fp32."""
    from avsr_tpu_torch.models.decoder import TransformerDecoder
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl

    c, heads, f, pos, lanes = AUTO_DIM, AUTO_HEADS, 3072, 250, BEAM
    nl = B * lanes
    out = {}
    q, kvs, row, lb = decode_case(g, dev, B, pos, caches=LAYERS, c=c,
                                  dtype=torch.float32)
    before = kvs[0].clone()
    got, got_kv = pda.decode_attention(pos, q, kvs[0].clone(), lb, lanes,
                                       heads, row)
    want, want_kv = pda.decode_attention_plain(pos, q, before.clone(), lb,
                                               lanes, heads, row)
    bnd = pda.output_bound(pos, q, before, lb, lanes, heads, row)
    diff = (got - want).abs()
    check(torch.equal(got_kv, want_kv) and bool((diff <= bnd).all()),
          "decode_attention disagrees at C=768, 12 heads, fp32")

    def step(kv):
        return pda.decode_attention(pos, q, kv, lb, lanes, heads, row)

    sdpa, backend = decode_sdpa_ms(q, kvs, lb, lanes, heads)
    out["decode_attention"] = (
        cuda_ms(rotating(step, kvs)),
        cuda_ms(lambda: pda.decode_attention_plain(pos, q, kvs[0], lb, lanes,
                                                   heads, row)),
        sdpa, bound(nbytes(q, kvs[0], lb, row, q, row),
                    4 * nl * lanes * KV_CAP * c, "fp32"))
    print(f"# decode_attention at C=768, 12 heads, fp32, B={B}, pos {pos}: "
          f"max_abs_err {diff.max().item():.3e} (within output_bound); "
          f"SDPA backend {backend}")
    del kvs

    s_enc = FRAMES + 2
    for cw, hw, dtype in ((c, heads, torch.float32), (c, heads, torch.bfloat16),
                          (1024, 16, torch.float32)):
        name = f"C={cw}, {hw} heads, {str(dtype)[6:]}"
        case = layer_case(g, dev, B, pos, layers=LAYERS, s_enc=s_enc, c=cw,
                          heads=hw, dtype=dtype)
        args = (case["srcs"][0][0], case["srcs"][0][1], case["mem_bias"],
                case["lb"], case["packs"][0], lanes, hw)
        kv = case["kvs"][0]
        got, got_kv = pdl.decoder_layer_step(pos, case["x"], kv.clone(),
                                             *args)
        want, want_kv = pdl.decoder_layer_step_plain(pos, case["x"],
                                                     kv.clone(), *args)
        r = min(pos, KV_CAP - 1)
        e_x, e_row = _rel_err(got, want), _rel_err(got_kv[:, r],
                                                   want_kv[:, r])
        lim = 1e-3 if dtype == torch.float32 else 2e-2
        check(e_x <= lim and e_row <= lim,
              f"decoder_layer_step disagrees at {name}: x_out {e_x:.2e}, "
              f"row {e_row:.2e}")
        scratch = pdl.layer_scratch(nl, cw, f, dev)

        def fused(i, case=case, scratch=scratch, hw=hw):
            return pdl.decoder_layer_step(
                pos, case["x"], case["kvs"][i], *case["srcs"][i],
                case["mem_bias"], case["lb"], case["packs"][i], lanes, hw,
                scratch=scratch)

        dt = str(dtype)[6:]
        dec = TransformerDecoder(VOCAB, cw, hw, f, layers=LAYERS,
                                 cache_dtype=dt, param_dtype=dt).to(dev)
        for i, mod in enumerate(case["mods"]):
            dec.decoders[i].load_state_dict(mod.state_dict())
        cache = dec.init_cache(torch.randn(B, s_enc, cw, generator=g,
                                           device=dev), KV_CAP, lanes)
        mask = (case["mem_bias"] == 0)[:, None, :]
        with torch.inference_mode():
            unfused = cuda_ms(rotating(
                lambda i, dec=dec, cache=cache, mask=mask, case=case:
                dec.layer_step(i, case["x"], pos, cache, mask, case["lb"],
                               lanes), range(LAYERS)))
        ms = cuda_ms(rotating(fused, range(LAYERS)))
        plan, smem = pdl.card_plan(nl, lanes, hw, cw, f, KV_CAP, s_enc,
                                   dtype, dtype, dev.index)
        print(f"# decoder_layer_step at {name}, F=3072, B={B}, pos {pos}: "
              f"x_out {e_x:.2e}, row {e_row:.2e} of their largest entry "
              f"(limit {lim:g}); cold {ms:.4f} ms (grid {plan.grid}, "
              f"{smem} B shared memory, item rows {plan.rows}, K slices "
              f"{plan.slices}), the unfused layer step {unfused:.4f} ms")
        if dtype == torch.float32 and cw == c:
            packed = case["packs"][0]
            out["decoder_layer_step"] = (
                ms,
                cuda_ms(lambda: pdl.decoder_layer_step_plain(
                    pos, case["x"], kv, *args)),
                unfused,
                bound(sum(nbytes(t) for t in packed)
                      + nbytes(case["x"], kv, *case["srcs"][0],
                               case["mem_bias"], case["lb"], case["x"],
                               kv[:, 0]),
                      2 * nl * 12 * c * c
                      + 4 * nl * c * (lanes * KV_CAP + s_enc), "fp32"))
        del case, dec, cache, scratch, kv
    for name, (ms, plain, other, bnd) in out.items():
        what = "SDPA" if name == "decode_attention" else "unfused layer step"
        print(f"# {name} C=768 fp32 B={B} cold: kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms, {what} {other:.4f} ms; bound {bnd[0]:.6f} ms "
              f"({bnd[1]})")
    return out


def phase_auto_avsr(dev, smi: str):
    """The eval CLI's auto_avsr path at full width: ``ConformerAVSR()``
    (two 12x768 conformer encoders over the Conv3d + swish ResNet-18 video
    frontend and the raw-waveform ResNet-1D, an 8192-wide fusion head, a
    6x768 decoder, vocabulary 5049 through ``model_kwargs``) of seed-0
    weights, saved as a reference-format .pth and loaded through
    ``InferenceEngine(model_type="auto_avsr")`` on the card, with a toy
    tokenizer. (b) ``eval_lrs2`` on 8 utterances of 2-15 s as mp4 + wav
    bytes (phase 8's kind), beam 3, ctc_weight 0.1, one warm pass and one
    timed; the encode and beam ms of a B=8 batch of 15 s utterances; peak
    memory. (c) two short utterances (3 s, 2.4 s) through the card's
    Recognizer (kernels) and a CPU one (twins) on the same weights, fp32:
    tokens equal, features, CTC log-probs and scores within phase 5's
    limits. (d) the same on the card with ``fused_bookkeeping`` (bit-equal
    to the unfused run) and with the decoder's fused layer (against the
    CPU's fused layer, as (c)). (e) every card run's launches of B2, B3,
    B5 (with B4's rows) and B8 or B9, counted from 0, and no twin called.
    Returns the launches of the unfused and fused runs and B2's and B9's
    times at C=768."""
    import tempfile

    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.data.synthetic import smooth_crops
    from avsr_tpu_torch.decode.recognizer import Recognizer, pick_bucket
    from avsr_tpu_torch.models.conformer import ConformerAVSR
    from avsr_tpu_torch.ops.kernels import beam_update as pbu
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl
    from avsr_tpu_torch.ops.kernels import row_gather as prg
    from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl
    from avsr_tpu_torch.ops.kernels import topk as ptk

    counters = (pda.decode_attention, ptk.topk_lastdim, ptk.topk_gather_rows,
                prg.row_gather, psl.cumlogsumexp, pbu.beam_update,
                pdl.decoder_layer_step)

    def reset():
        for fn in counters:
            fn.launches = 0
        ptk.topk_lastdim.flat_launches = ptk.topk_lastdim.wide_launches = 0
        pbu.beam_update.wide_launches = 0
        pda.decode_attention.wide_launches = 0

    def counts():
        n = {fn.__name__: fn.launches for fn in counters}
        n["topk_lastdim_flat"] = ptk.topk_lastdim.flat_launches
        n["topk_lastdim"] -= n["topk_lastdim_flat"]
        n["wide"] = (ptk.topk_lastdim.wide_launches
                     + pbu.beam_update.wide_launches
                     + pda.decode_attention.wide_launches)
        return n

    def check_launches(name, n, layers, fused=False, fused_layer=False):
        """(e): the kernels of the path once a layer or twice a step, none
        of the others, no wide path at beam 3."""
        per_step = (n["decoder_layer_step"] if fused_layer
                    else n["decode_attention"])
        steps = per_step // layers
        check(steps >= 1 and per_step == steps * layers
              and n["topk_gather_rows"] == steps and n["row_gather"] == 0
              and n["topk_lastdim"] >= steps
              and n["cumlogsumexp"] >= 2 * steps and n["wide"] == 0
              and (n["beam_update"] >= steps if fused
                   else n["beam_update"] == 0)
              and (fused or n["topk_lastdim_flat"] >= steps)
              and (n["decode_attention"] == 0 if fused_layer
                   else n["decoder_layer_step"] == 0),
              f"{name}: the beam's kernels did not run as it does ({n})")
        return steps

    from avsr_tpu_torch.cli import evaluation as pe
    from avsr_tpu_torch.data import media, tokenizer

    assets = tokenizer._DEFAULT_ASSET_DIRS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_auto_") as root:
        tokenizer._DEFAULT_ASSET_DIRS = (os.path.join(root, "spm"),)
        os.makedirs(tokenizer._DEFAULT_ASSET_DIRS[0])
        try:
            write_toy_tokenizer(tokenizer._DEFAULT_ASSET_DIRS[0], VOCAB - 2)
            # (a) seed-0 weights as a reference-format .pth, through the CLI
            t0 = time.perf_counter()
            with torch.device(dev):
                model = ConformerAVSR(odim=VOCAB)
            init_weights(model, torch.Generator(device=dev).manual_seed(0))
            pth = os.path.join(root, "auto_avsr.pth")
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       pth)
            n_params = sum(p.numel() for p in model.parameters())
            del model
            t1 = time.perf_counter()
            engine = pe.InferenceEngine("auto_avsr", checkpoint_path=pth,
                                        batch_size=AUTO_UTTERANCES,
                                        model_kwargs={"odim": VOCAB})
            engine.load_model()
            rec = engine.recognizer
            model = rec.model
            print(f"# phase 10: ConformerAVSR() of {n_params} parameters; "
                  f".pth written in {t1 - t0:.1f} s, loaded through the "
                  f"auto_avsr loader in {time.perf_counter() - t1:.1f} s")
            dec = model.decoder
            check(engine.device == "cuda" and rec.device.type == "cuda"
                  and rec.beam_size == 3 and rec.ctc_weight == 0.1
                  and not rec.fused_bookkeeping
                  and (rec.audio_rate, rec.audio_dim) == (640, 1)
                  and model.odim == VOCAB and dec.dim == AUTO_DIM
                  and dec.heads == AUTO_HEADS and len(dec.decoders) == LAYERS
                  and len(model.encoder.encoders) == 12
                  and model.fusion.fc1.out_features == 8192,
                  "phase 10: the engine is not the full-width auto_avsr "
                  "model at the CLI's defaults")

            # (b) eval_lrs2 on mp4 + wav bytes
            rng = np.random.RandomState(10)
            frames = np.round(rng.uniform(*EVAL_SECONDS, AUTO_UTTERANCES)
                              * 25).astype(int)
            frames[0] = FRAMES  # one 15 s utterance: the 384 bucket

            def samples_of(lengths, name):
                out = []
                for i, n in enumerate(lengths):
                    path = os.path.join(root, f"{name}{i}.mp4")
                    media.save_video(path, smooth_crops(rng, n, 96)[..., 0])
                    media.save_audio(path[:-4] + ".wav", (
                        0.1 * rng.randn(n * 640)).astype(np.float32))
                    with open(path, "rb") as f, open(path[:-4] + ".wav",
                                                     "rb") as g:
                        out.append({"video": f.read(), "audio": g.read(),
                                    "label": " ".join(rng.choice(
                                        EVAL_WORDS, rng.randint(2, 12)))})
                return out

            samples = samples_of(frames, "utt")
            audio_s = float(frames.sum()) / 25.0
            tokens, post = [], engine._decode_tokens

            def decode_tokens(toks):
                tokens.append(np.array(toks))
                return post(toks)

            engine._decode_tokens = decode_tokens
            torch.cuda.reset_peak_memory_stats()
            passes = []
            with twin_calls(SERVING_TWINS) as calls:
                for _ in range(2):  # a warm pass, then the timed one
                    del tokens[:]
                    torch.cuda.synchronize()
                    reset()
                    t0 = time.perf_counter()
                    score = pe.eval_lrs2(engine, samples)
                    wall = time.perf_counter() - t0
                    passes.append(list(tokens))
            main = counts()
            check(not any(calls.values()),
                  f"phase 10: a twin ran in eval_lrs2 ({calls})")
            steps = check_launches("phase 10 eval_lrs2", main, LAYERS)
            check(len(tokens) == AUTO_UTTERANCES and math.isfinite(score)
                  and all(np.array_equal(a, b)
                          for a, b in zip(*passes)),
                  "phase 10: eval_lrs2's transcripts missing or unsteady")
            print(f"# {smi}: phase 10 auto_avsr eval_lrs2: "
                  f"{AUTO_UTTERANCES} utterances, {audio_s:.2f} audio-s in "
                  f"{wall:.3f} s wall (after a warm pass; media decode and "
                  f"collation included) -> {audio_s / wall:.2f} audio-s/s; "
                  f"WER {score:.4f}; {steps} beam steps; launches {main}")

            # the encode and beam of a B=8 batch of 15 s utterances (the
            # shapes eval_lrs2's batch warmed: 8 rows of the 384 bucket)
            vids = [rng.randn(FRAMES, 88, 88, 1).astype(np.float32)
                    for _ in range(B)]
            auds = [rng.randn(FRAMES * 640, 1).astype(np.float32)
                    for _ in range(B)]
            aud, vid, lens, _ = rec._pad_batch(auds, vids)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            feats, ctc = rec.encode(aud, vid, lens)
            torch.cuda.synchronize()
            s1 = time.perf_counter()
            _, yl, sc = rec.beam(feats, ctc, lens)
            torch.cuda.synchronize()
            s2 = time.perf_counter()
            check(tuple(ctc.shape) == (B, pick_bucket(rec.t_buckets, FRAMES),
                                       VOCAB)
                  and torch.isfinite(ctc).all().item()
                  and torch.isfinite(sc).all().item(),
                  "phase 10: the B=8 batch's CTC log-probs or scores")
            peak = torch.cuda.max_memory_allocated() / 1e9
            enc_ms, beam_ms = 1e3 * (s1 - s0), 1e3 * (s2 - s1)
            print(f"# {smi}: phase 10 auto_avsr B={B} x {FRAMES} frames "
                  f"(fp32 encode and decoder, beam 3, ctc_weight 0.1): "
                  f"encode {enc_ms:.1f} ms, beam {beam_ms:.1f} ms "
                  f"({int(yl.max().item())} tokens with sos/eos); peak "
                  f"memory {peak:.2f} GB")
            del feats, ctc, aud, vid, auds, vids

            # (c) and (d): the card's kernels and the CPU's twins, fp32
            feats_in = engine._features(samples_of(AUTO_SHORT, "short"))
            auds = [np.asarray(a)[: n * 640] for a, _, n in feats_in]
            vids = [np.asarray(v)[:n] for _, v, n in feats_in]
            cpu_model = copy.deepcopy(model).cpu()
            cpu = Recognizer(model=cpu_model, cfg=cpu_model, device="cpu",
                             audio_rate=640, audio_dim=1,
                             max_decode_tokens=rec.max_decode_tokens)

            def run(r, fused=False, encoded=None):
                """[feats, CTC log-probs, tokens, lengths, scores] on the
                host; ``encoded``: the encode's outputs, reused."""
                r.fused_bookkeeping = fused
                aud, vid, lens, _ = r._pad_batch(auds, vids)
                feats, ctc = encoded or r.encode(aud, vid, lens)
                return [x.cpu() for x in (feats, ctc,
                                          *r.beam(feats, ctc, lens))]

            runs = {}
            with twin_calls(SERVING_TWINS) as calls:
                for name, fused, fused_layer in (
                        ("unfused", False, False),
                        ("fused bookkeeping", True, False),
                        ("fused layer", False, True)):
                    dec.fused_layer = fused_layer
                    torch.cuda.synchronize()
                    reset()
                    runs[name] = run(rec, fused)
                    torch.cuda.synchronize()
                    runs[name].append(counts())
                    check_launches(f"phase 10 {name}", runs[name][-1],
                                   LAYERS, fused, fused_layer)
                dec.fused_layer = False
            check(not any(calls.values()),
                  f"phase 10: a twin ran on the card ({calls})")
            rec.fused_bookkeeping = False
            u, fb = runs["unfused"], runs["fused bookkeeping"]
            check(all(torch.equal(a, b) for a, b in zip(u[2:5], fb[2:5])),
                  "phase 10: fused bookkeeping differs from unfused on the "
                  "card")
            cpu_out = run(cpu)
            for name in ("unfused", "fused layer"):
                cpu_model.decoder.fused_layer = name == "fused layer"
                cu = runs[name]
                cp = cpu_out if name == "unfused" else run(
                    cpu, encoded=cpu_out[:2])
                feat_err = _rel_err(cu[0], cp[0])
                ctc_err = (cu[1] - cp[1]).abs().max().item()
                score_err = ((cu[4] - cp[4]).abs()
                             / cp[4].abs()).max().item()
                same = torch.equal(cu[2], cp[2]) and torch.equal(cu[3], cp[3])
                print(f"# phase 10 cuda vs cpu, {name}, fp32, B=2 x "
                      f"{AUTO_SHORT} frames: features {feat_err:.3e} of "
                      f"their largest (limit {AUTO_FEAT_TOL:g}), CTC "
                      f"log-probs max_abs_err {ctc_err:.3e} (limit "
                      f"{AUTO_CTC_TOL:g}), beam score rel_err "
                      f"{score_err:.3e} (limit {AUTO_SCORE_TOL:g}), tokens "
                      f"equal={same} (lengths {cu[3].tolist()}); tokens "
                      f"equal to the card's unfused run: "
                      f"{torch.equal(cu[2], u[2])}; launches {cu[-1]}")
                check(feat_err <= AUTO_FEAT_TOL and ctc_err <= AUTO_CTC_TOL
                      and score_err <= AUTO_SCORE_TOL and same,
                      f"phase 10 {name}: cuda vs cpu")
            launches = {"eval_lrs2": main, "fused bookkeeping": fb[-1],
                        "fused layer": runs["fused layer"][-1]}
            del cpu, cpu_model, runs, engine, rec, model, dec
            torch.cuda.empty_cache()
            times = conformer_width_times(dev, torch.Generator(
                device=dev).manual_seed(10))
        finally:
            tokenizer._DEFAULT_ASSET_DIRS = assets
    torch.cuda.empty_cache()
    return launches, times


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
        lines = log.read_text().splitlines()
        for prev, line in zip([""] + lines, lines):
            if "spill" in line and ", 0 bytes spill stores" not in line:
                print(f"#   ptxas {prev.strip()}: {line.strip()}")

    print("# phase 3: kernels vs plain twins at the serving and training "
          "shapes")
    records = phase_kernels(dev)
    serving_fwd = records["flash_attention_fwd"]
    print(f"# flash_attention_fwd at the serving shape (B=8, no dropout): "
          f"kernel {serving_fwd['ms']:.4f} ms, plain "
          f"{serving_fwd['plain_ms']:.4f} ms, library "
          f"{serving_fwd['library_ms']:.4f} ms ({serving_fwd['library']})")
    records.update(phase_train_kernels(dev))
    records.update(phase_fuse_kernels(dev))
    print("# phase 4: full-width serving, bf16, B=8, 375 frames")
    runs = phase_serving(dev, smi)
    print("# phase 5: full-width slice parity, cuda vs cpu")
    phase_parity(dev)
    print("# phase 6: full-width training, bf16, B=6, 384 frames")
    train_launches, plain_res = phase_training(dev, smi)
    stem_launches, stem_res = phase_training(dev, smi, fused_stem=True)
    print(f"# {smi}: training with AVSR_FUSED_STEM=1 vs without: "
          f"{stem_res['sec_per_step'] * 1e3:.1f} vs "
          f"{plain_res['sec_per_step'] * 1e3:.1f} ms a step, peak memory "
          f"{stem_res['peak_mem_gb']:.2f} vs {plain_res['peak_mem_gb']:.2f} "
          f"GB")
    print("# phase 7: full-width train-step parity, cuda vs cpu")
    phase_train_parity(dev)
    phase_train_parity(dev, fused_stem=True)
    print("# phase 8: the evaluation entry point at full width")
    eval_runs, eval_checked = phase_eval(dev, smi)
    print("# phase 9: the training entry point at full width")
    phase_train_cli(dev, smi)
    print("# phase 10: the eval CLI's auto_avsr path at full width")
    t10 = time.perf_counter()
    auto_launches, auto_times = phase_auto_avsr(dev, smi)
    print(f"# phase 10 passed in {time.perf_counter() - t10:.1f} s")
    print(f"# phase 10 launches: {json.dumps(auto_launches)}")
    print(f"# phase 10 C=768 kernel ms (kernel, twin, SDPA or unfused "
          f"step, bound): {json.dumps(auto_times)}")
    print(f"# all phases passed in {time.perf_counter() - t_start:.1f} s")

    # launches: each kernel's count in the run of its path (the fused
    # stem's four from the AVSR_FUSED_STEM=1 training run, the fused
    # layer's from the fused-layer beam run)
    main_path = runs["beam ctc_weight=0.1"]
    main_path["beam_update"] = runs["beam ctc_weight=0.1 fused"]["beam_update"]
    main_path["decoder_layer_step"] = runs[
        "beam ctc_weight=0.1, fused layer and stem"]["decoder_layer_step"]
    main_path.update(train_launches)
    main_path.update({k: v for k, v in stem_launches.items()
                      if k.startswith("bn_prelu_pool")})
    # C28's kernels: phase 8's beam of 22, unfused (top-k) and fused
    main_path["topk_lastdim_wide"] = eval_runs["beam 22"]["topk_lastdim_wide"]
    main_path["beam_update_wide"] = eval_runs["beam 22 fused"][
        "beam_update_wide"]
    main_path["decode_attention_wide"] = eval_runs["beam 22"][
        "decode_attention_wide"]
    # their errors over phase 3's cases and phase 8's checked beams
    for name, entry in eval_checked.items():
        if name in records:
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                               entry["err"])
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
