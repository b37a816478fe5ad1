"""The avsr-family weight mapping between torch and flax layouts.

The port's own copy of the parts of ``avsr_tpu/core/checkpoint.py`` that
``core/weights.py`` needs (the port imports nothing of the JAX package;
``tests/test_torch_port_ctc.py`` holds the copy equal to the original): the
leaf transforms, the ``avsr_mapping`` table of (torch key, flax path,
transform, collection) entries for the AV-HuBERT encoder, CTC head and
transformer decoder of the released AVSRCocktail checkpoint, the
conformer family's tables (``conformer_avsr_mapping`` for auto_avsr,
``conformer_asr_mapping`` for auto_asr / auto_vsr), the MuAViC table
(``av2text_mapping``), the key normalisation of released state dicts,
``flax_to_torch`` and the state-dict reader. Everything works on numpy
arrays.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from avsr_tpu_torch.core.config import AVHubertAVSRConfig

# Leaf-kind transforms: torch layout -> flax layout.


def _dense(w):  # (O, I) -> (I, O)
    return np.ascontiguousarray(np.transpose(w))


def _conv2d(w):  # (O, I, kh, kw) -> (kh, kw, I, O)
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv3d(w):  # (O, I, kt, kh, kw) -> (kt, kh, kw, I, O)
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _conv1d(w):  # (O, I/g, K) -> (K, I/g, O)
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _copy(w):
    return np.asarray(w)


def _resnet_block_entries(
    tprefix: str, fprefix: Tuple[str, ...], has_ds: bool, prelu: bool = True
):
    """Mapping entries for one BasicBlock (resnet.py:30-69)."""
    out = [
        (f"{tprefix}.conv1.weight", fprefix + ("conv1", "kernel"), _conv2d, "p"),
        (f"{tprefix}.bn1.weight", fprefix + ("bn1", "scale"), _copy, "p"),
        (f"{tprefix}.bn1.bias", fprefix + ("bn1", "bias"), _copy, "p"),
        (f"{tprefix}.bn1.running_mean", fprefix + ("bn1", "mean"), _copy, "s"),
        (f"{tprefix}.bn1.running_var", fprefix + ("bn1", "var"), _copy, "s"),
        (f"{tprefix}.conv2.weight", fprefix + ("conv2", "kernel"), _conv2d, "p"),
        (f"{tprefix}.bn2.weight", fprefix + ("bn2", "scale"), _copy, "p"),
        (f"{tprefix}.bn2.bias", fprefix + ("bn2", "bias"), _copy, "p"),
        (f"{tprefix}.bn2.running_mean", fprefix + ("bn2", "mean"), _copy, "s"),
        (f"{tprefix}.bn2.running_var", fprefix + ("bn2", "var"), _copy, "s"),
    ]
    if prelu:
        out += [
            (f"{tprefix}.relu1.weight", fprefix + ("relu1", "alpha"), _copy, "p"),
            (f"{tprefix}.relu2.weight", fprefix + ("relu2", "alpha"), _copy, "p"),
        ]
    if has_ds:
        out += [
            (f"{tprefix}.downsample.0.weight", fprefix + ("downsample_conv", "kernel"), _conv2d, "p"),
            (f"{tprefix}.downsample.1.weight", fprefix + ("downsample_bn", "scale"), _copy, "p"),
            (f"{tprefix}.downsample.1.bias", fprefix + ("downsample_bn", "bias"), _copy, "p"),
            (f"{tprefix}.downsample.1.running_mean", fprefix + ("downsample_bn", "mean"), _copy, "s"),
            (f"{tprefix}.downsample.1.running_var", fprefix + ("downsample_bn", "var"), _copy, "s"),
        ]
    return out


def _mha_entries(tprefix: str, fprefix: Tuple[str, ...], names):
    out = []
    for tname, fname in names:
        out += [
            (f"{tprefix}.{tname}.weight", fprefix + (fname, "kernel"), _dense, "p"),
            (f"{tprefix}.{tname}.bias", fprefix + (fname, "bias"), _copy, "p"),
        ]
    return out


def _ln_entries(tprefix: str, fprefix: Tuple[str, ...]):
    return [
        (f"{tprefix}.weight", fprefix + ("scale",), _copy, "p"),
        (f"{tprefix}.bias", fprefix + ("bias",), _copy, "p"),
    ]


def _linear_entries(tprefix: str, fprefix: Tuple[str, ...]):
    return [
        (f"{tprefix}.weight", fprefix + ("kernel",), _dense, "p"),
        (f"{tprefix}.bias", fprefix + ("bias",), _copy, "p"),
    ]


def avhubert_encoder_entries(tp: str, enc: Tuple[str, ...], n_layers: int,
                             fused_proj: bool = True, prelu: bool = True):
    """Mapping for one AVHubertModel encoder (backbones/avhubert.py:200).

    tp: torch prefix for the encoder module (e.g. 'avsr.encoder' or
    'model.encoder'); enc: flax path prefix. ``prelu``: the video
    frontend's activation is PReLU (``resnet_relu_type``), whose weights
    the stem and the trunk's blocks hold; the JAX package's table always
    lists them.
    """
    m = []
    # modality feature extractors
    m += _linear_entries(f"{tp}.feature_extractor_audio.proj", enc + ("audio_proj",))
    m += _linear_entries(f"{tp}.feature_extractor_video.proj", enc + ("video_proj",))
    rn = enc + ("video_resnet",)
    rtp = f"{tp}.feature_extractor_video.resnet"
    m += [
        (f"{rtp}.frontend3D.0.weight", rn + ("frontend_conv", "kernel"), _conv3d, "p"),
        (f"{rtp}.frontend3D.1.weight", rn + ("frontend_bn", "scale"), _copy, "p"),
        (f"{rtp}.frontend3D.1.bias", rn + ("frontend_bn", "bias"), _copy, "p"),
        (f"{rtp}.frontend3D.1.running_mean", rn + ("frontend_bn", "mean"), _copy, "s"),
        (f"{rtp}.frontend3D.1.running_var", rn + ("frontend_bn", "var"), _copy, "s"),
    ]
    if prelu:
        m += [(f"{rtp}.frontend3D.2.weight", rn + ("frontend_prelu", "alpha"), _copy, "p")]
    for stage in range(1, 5):
        for b in range(2):
            has_ds = stage > 1 and b == 0
            m += _resnet_block_entries(
                f"{rtp}.trunk.layer{stage}.{b}",
                rn + ("trunk", f"layer{stage}_{b}"),
                has_ds, prelu,
            )
    # fusion + projection
    m += _ln_entries(f"{tp}.layer_norm", enc + ("fuse_norm",))
    if fused_proj:
        m += _linear_entries(f"{tp}.post_extract_proj", enc + ("post_extract_proj",))
    # transformer encoder
    tr = enc + ("encoder",)
    ttp = f"{tp}.encoder"
    m += [
        (f"{ttp}.pos_conv_embed.conv.weight_g", tr + ("pos_conv", "weight_g"), _copy, "p"),
        (f"{ttp}.pos_conv_embed.conv.weight_v", tr + ("pos_conv", "weight_v"), _copy, "p"),
        (f"{ttp}.pos_conv_embed.conv.bias", tr + ("pos_conv", "bias"), _copy, "p"),
    ]
    m += _ln_entries(f"{ttp}.layer_norm", tr + ("final_norm",))
    # encoder layers are scanned: torch per-layer tensors stack on axis 0
    lf = tr + ("layers",)
    per_layer = []
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        per_layer += [
            (f"attention.{proj}.weight", ("attention", proj, "kernel"), _dense),
            (f"attention.{proj}.bias", ("attention", proj, "bias"), _copy),
        ]
    for ln in ("layer_norm", "final_layer_norm"):
        per_layer += [
            (f"{ln}.weight", (ln, "scale"), _copy),
            (f"{ln}.bias", (ln, "bias"), _copy),
        ]
    for ff in ("intermediate_dense", "output_dense"):
        per_layer += [
            (f"feed_forward.{ff}.weight", (ff, "kernel"), _dense),
            (f"feed_forward.{ff}.bias", (ff, "bias"), _copy),
        ]
    for tsuffix, fsuffix, transform in per_layer:
        keys = [f"{ttp}.layers.{i}.{tsuffix}" for i in range(n_layers)]
        m.append((keys, lf + fsuffix, transform, "p"))
    return m


def avsr_mapping(cfg: AVHubertAVSRConfig, prefix: str = "avsr."):
    """Full (torch_key, flax_path, transform, collection) table.

    collection: "p" = params, "s" = batch_stats.
    """
    P = prefix
    m = []
    m += avhubert_encoder_entries(
        f"{P}encoder", ("encoder",), cfg.encoder.num_hidden_layers,
        fused_proj=cfg.encoder.fused_dim != cfg.encoder.encoder_embed_dim,
        prelu=cfg.encoder.resnet_relu_type == "prelu",
    )
    # CTC head
    m += _linear_entries(f"{P}ctc.ctc_lo", ("ctc_lo",))
    # decoder
    if cfg.mtlalpha < 1:
        m += _decoder_entries(f"{P}decoder", ("decoder",), cfg.dlayers)
    if cfg.adim != cfg.ddim:
        m += _linear_entries(f"{P}proj_decoder", ("proj_decoder",))
    return m


def pretrain_mapping(encoder_cfg, prefix: str = ""):
    """(torch_key, flax_path, transform, collection) table of the
    pretraining model (``train/pretrain.AVHubertPretrainModel``): the avsr
    encoder's entries under ``hubert``, plus ``mask_emb``, ``final_proj``
    and ``label_embs``. The JAX package has no such table: this is the
    weight bridge its pretraining variables cross to the port by."""
    P = prefix
    m = avhubert_encoder_entries(
        f"{P}hubert", ("hubert",), encoder_cfg.num_hidden_layers,
        fused_proj=encoder_cfg.fused_dim != encoder_cfg.encoder_embed_dim,
        prelu=encoder_cfg.resnet_relu_type == "prelu",
    )
    m += [(f"{P}mask_emb", ("mask_emb",), _copy, "p"),
          (f"{P}label_embs", ("label_embs",), _copy, "p")]
    m += _linear_entries(f"{P}final_proj", ("final_proj",))
    return m


def _decoder_entries(dt: str, df: Tuple[str, ...], dlayers: int):
    """ESPnet transformer decoder -> scanned (stacked) flax layer stack."""
    m = [(f"{dt}.embed.0.weight", df + ("embed", "embedding"), _copy, "p")]
    per_layer = []
    for attn in ("self_attn", "src_attn"):
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            per_layer += [
                (f"{attn}.{proj}.weight", (attn, proj, "kernel"), _dense),
                (f"{attn}.{proj}.bias", (attn, proj, "bias"), _copy),
            ]
    for n in (1, 2, 3):
        per_layer += [
            (f"norm{n}.weight", (f"norm{n}", "scale"), _copy),
            (f"norm{n}.bias", (f"norm{n}", "bias"), _copy),
        ]
    for wname in ("w_1", "w_2"):
        per_layer += [
            (f"feed_forward.{wname}.weight", (wname, "kernel"), _dense),
            (f"feed_forward.{wname}.bias", (wname, "bias"), _copy),
        ]
    for tsuffix, fsuffix, transform in per_layer:
        keys = [f"{dt}.decoders.{i}.{tsuffix}" for i in range(dlayers)]
        m.append((keys, df + ("blocks",) + fsuffix, transform, "p"))
    m += _ln_entries(f"{dt}.after_norm", df + ("after_norm",))
    m += _linear_entries(f"{dt}.output_layer", df + ("output_layer",))
    return m


def _resnet2d_trunk_entries(tprefix: str, fprefix: Tuple[str, ...],
                            prelu: bool = False):
    out = []
    for stage in range(1, 5):
        for b in range(2):
            has_ds = stage > 1 and b == 0
            out += _resnet_block_entries(
                f"{tprefix}.layer{stage}.{b}", fprefix + (f"layer{stage}_{b}",),
                has_ds, prelu,
            )
    return out


def _bn_entries(tprefix: str, fprefix: Tuple[str, ...]):
    return [
        (f"{tprefix}.weight", fprefix + ("scale",), _copy, "p"),
        (f"{tprefix}.bias", fprefix + ("bias",), _copy, "p"),
        (f"{tprefix}.running_mean", fprefix + ("mean",), _copy, "s"),
        (f"{tprefix}.running_var", fprefix + ("var",), _copy, "s"),
    ]


def _conformer_encoder_entries(tp: str, fp: Tuple[str, ...], n_layers: int,
                               input_layer: str):
    """Mapping for one reference conformer Encoder (encoder.py:46)."""
    m = []
    if input_layer == "conv3d":
        fr = fp + ("frontend",)
        m += [
            (f"{tp}.frontend.frontend3D.0.weight", fr + ("frontend_conv", "kernel"), _conv3d, "p"),
        ]
        m += _bn_entries(f"{tp}.frontend.frontend3D.1", fr + ("frontend_bn",))
        m += _resnet2d_trunk_entries(f"{tp}.frontend.trunk", fr + ("trunk",))
    elif input_layer == "conv1d":
        fr = fp + ("frontend",)
        m += [(f"{tp}.frontend.trunk.conv1.weight", fr + ("conv1", "kernel"), _conv1d, "p")]
        m += _bn_entries(f"{tp}.frontend.trunk.bn1", fr + ("bn1",))
        for stage in range(1, 5):
            for b in range(2):
                has_ds = stage > 1 and b == 0
                btp = f"{tp}.frontend.trunk.layer{stage}.{b}"
                bfp = fr + (f"layer{stage}_{b}",)
                m += [
                    (f"{btp}.conv1.weight", bfp + ("conv1", "kernel"), _conv1d, "p"),
                    (f"{btp}.conv2.weight", bfp + ("conv2", "kernel"), _conv1d, "p"),
                ]
                m += _bn_entries(f"{btp}.bn1", bfp + ("bn1",))
                m += _bn_entries(f"{btp}.bn2", bfp + ("bn2",))
                if has_ds:
                    m += [(f"{btp}.downsample.0.weight", bfp + ("downsample_conv", "kernel"), _conv1d, "p")]
                    m += _bn_entries(f"{btp}.downsample.1", bfp + ("downsample_bn",))
    m += _linear_entries(f"{tp}.embed.0", fp + ("embed",))
    m += _ln_entries(f"{tp}.after_norm", fp + ("after_norm",))

    # scanned conformer layers: per-layer tensors stack on axis 0
    per_layer = []  # (torch suffix, flax suffix, transform, collection)
    for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
        per_layer += [
            (f"self_attn.{proj}.weight", ("self_attn", proj, "kernel"), _dense, "p"),
            (f"self_attn.{proj}.bias", ("self_attn", proj, "bias"), _copy, "p"),
        ]
    per_layer += [
        ("self_attn.linear_pos.weight", ("self_attn", "linear_pos", "kernel"), _dense, "p"),
        ("self_attn.pos_bias_u", ("self_attn", "pos_bias_u"), _copy, "p"),
        ("self_attn.pos_bias_v", ("self_attn", "pos_bias_v"), _copy, "p"),
    ]
    for ff in ("feed_forward", "feed_forward_macaron"):
        for wname in ("w_1", "w_2"):
            per_layer += [
                (f"{ff}.{wname}.weight", (ff, wname, "kernel"), _dense, "p"),
                (f"{ff}.{wname}.bias", (ff, wname, "bias"), _copy, "p"),
            ]
    for ln in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv", "norm_final"):
        per_layer += [
            (f"{ln}.weight", (ln, "scale"), _copy, "p"),
            (f"{ln}.bias", (ln, "bias"), _copy, "p"),
        ]
    # reference spells pointwise conv 'pointwise_cov' (convolution.py:28,46)
    for tc, fc, tr in (
        ("pointwise_cov1", "pointwise_conv1", _conv1d),
        ("depthwise_conv", "depthwise_conv", _conv1d),
        ("pointwise_cov2", "pointwise_conv2", _conv1d),
    ):
        per_layer += [
            (f"conv_module.{tc}.weight", ("conv_module", fc, "kernel"), tr, "p"),
            (f"conv_module.{tc}.bias", ("conv_module", fc, "bias"), _copy, "p"),
        ]
    per_layer += [
        ("conv_module.norm.weight", ("conv_module", "norm", "scale"), _copy, "p"),
        ("conv_module.norm.bias", ("conv_module", "norm", "bias"), _copy, "p"),
        ("conv_module.norm.running_mean", ("conv_module", "norm", "mean"), _copy, "s"),
        ("conv_module.norm.running_var", ("conv_module", "norm", "var"), _copy, "s"),
    ]
    for tsuffix, fsuffix, transform, coll in per_layer:
        keys = [f"{tp}.encoders.{i}.{tsuffix}" for i in range(n_layers)]
        m.append((keys, fp + ("layers",) + fsuffix, transform, coll))
    return m


def conformer_avsr_mapping(n_layers: int = 12, dlayers: int = 6, prefix: str = ""):
    """Mapping for the auto_avsr checkpoint (avsr_trlrwlrs2lrs3vox2avsp_base)."""
    P = prefix
    m = []
    m += _conformer_encoder_entries(f"{P}encoder", ("encoder",), n_layers, "conv3d")
    m += _conformer_encoder_entries(f"{P}aux_encoder", ("aux_encoder",), n_layers, "conv1d")
    m += _linear_entries(f"{P}fusion.fc1", ("fusion", "fc1"))
    m += _bn_entries(f"{P}fusion.bn1", ("fusion", "bn1"))
    m += _linear_entries(f"{P}fusion.fc2", ("fusion", "fc2"))
    m += _linear_entries(f"{P}ctc.ctc_lo", ("ctc_lo",))
    m += _decoder_entries(f"{P}decoder", ("decoder",), dlayers)
    return m


def av2text_mapping(encoder_layers: int = 12, decoder_layers: int = 6,
                    prefix: str = "model.", prelu: bool = True):
    """Mapping for the MuAViC AV2Text checkpoint (avhubert_muavic family)."""
    P = prefix
    m = avhubert_encoder_entries(
        f"{P}encoder", ("encoder",), encoder_layers, fused_proj=True,
        prelu=prelu,
    )
    dt = f"{P}decoder"
    df = ("decoder",)
    m += [(f"{dt}.embed_tokens.weight", df + ("embed_tokens", "embedding"), _copy, "p")]
    for i in range(decoder_layers):
        lt = f"{dt}.layers.{i}"
        lf = df + (f"blocks_{i}",)
        for attn in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                m += [
                    (f"{lt}.{attn}.{proj}.weight", lf + (attn, proj, "kernel"), _dense, "p"),
                    (f"{lt}.{attn}.{proj}.bias", lf + (attn, proj, "bias"), _copy, "p"),
                ]
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            m += _ln_entries(f"{lt}.{ln}", lf + (ln,))
        m += _linear_entries(f"{lt}.fc1", lf + ("fc1",))
        m += _linear_entries(f"{lt}.fc2", lf + ("fc2",))
    m += _ln_entries(f"{dt}.layer_norm", df + ("layer_norm",))
    return m


def conformer_asr_mapping(n_layers: int = 12, dlayers: int = 6,
                          input_layer: str = "conv1d", prefix: str = ""):
    """Mapping for auto_asr (conv1d) / auto_vsr (conv3d) checkpoints."""
    P = prefix
    m = []
    m += _conformer_encoder_entries(f"{P}encoder", ("encoder",), n_layers, input_layer)
    m += _linear_entries(f"{P}ctc.ctc_lo", ("ctc_lo",))
    m += _decoder_entries(f"{P}decoder", ("decoder",), dlayers)
    return m


# torch keys legitimately absent from the inference/fine-tune graph
_IGNORABLE_SUFFIXES = (
    "num_batches_tracked",
    "mask_emb",
    "label_embs_concat",
    "position_ids",
    "lm_head.weight",  # tied to decoder.embed_tokens (avhubert2text.py:17)
    "embed_positions.weights",  # sinusoidal buffer
)

# newer torch weight-norm spelling -> classic spelling
_PARAMETRIZATION_RENAMES = {
    ".parametrizations.weight.original0": ".weight_g",
    ".parametrizations.weight.original1": ".weight_v",
}


def normalize_torch_keys(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state.items():
        for old, new in _PARAMETRIZATION_RENAMES.items():
            if old in k:
                k = k.replace(old, new)
        out[k] = v
    return out


_INVERSE = {
    _dense: _dense,  # transpose is an involution
    _conv1d: _conv1d,  # so is swapping the first and last axes
    _copy: _copy,
}


def _inverse_transform(transform):
    if transform in _INVERSE:
        return _INVERSE[transform]
    if transform is _conv2d:
        return lambda w: np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))
    if transform is _conv3d:
        return lambda w: np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2)))
    raise ValueError(f"no inverse for transform {transform}")


def flax_to_torch(variables: Dict[str, Any], mapping) -> Dict[str, np.ndarray]:
    """Export flax variables back to a torch-layout state dict.

    The exact inverse of the JAX package's convert_state over the same
    mapping table.
    """

    def lookup(tree, path):
        node = tree
        for p in path:
            node = node[p]
        return np.asarray(node)

    state: Dict[str, np.ndarray] = {}
    for tkey, fpath, transform, coll in mapping:
        tree = variables["params"] if coll == "p" else variables["batch_stats"]
        inv = _inverse_transform(transform)
        arr = lookup(tree, fpath)
        if isinstance(tkey, list):  # stacked scanned layers -> unstack
            for i, k in enumerate(tkey):
                state[k] = inv(arr[i])
        else:
            state[tkey] = inv(arr)
    return state


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a state dict from a safetensors file/dir or a torch .pth/.bin."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k: v.numpy() for k, v in sd.items()}
