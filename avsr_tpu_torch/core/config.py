"""Model configurations (dataclasses, HF-config.json-field-compatible).

The port's own copy of ``avsr_tpu/core/config.py`` (the port imports nothing
of the JAX package; ``tests/test_torch_port_ctc.py`` holds the copy equal to
the original). Field names follow the reference's HF configs so released
checkpoints' ``config.json`` files load directly:
  - AVHubertAVSRConfig: avhubert_avsr/configuration_avhubert_avsr.py:15
  - decoder/CTC dims:   nets/backend/e2e_asr_avhubert.py:24
Only fields that affect the computation graph are kept; unknown json fields
are ignored on load. The Pallas, scan and remat switches are kept so that a
config round-trips through ``to_dict``/``from_dict`` unchanged; of them the
port reads ``decode_fused_layer`` and the remat switches (``scan_remat``,
``frontend_remat``); its other modules always take their kernel paths, and
``scan_unroll`` (an XLA scan knob) has no counterpart.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class AVHubertEncoderConfig:
    """AV-HuBERT encoder (wav2vec2-style transformer over fused AV features)."""

    encoder_embed_dim: int = 1024  # hidden size
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    audio_feat_dim: int = 104
    modality_fuse: str = "concat"  # 'concat' | 'add'
    modality: str = "av"  # 'av' | 'audio' | 'video'
    modality_dropout: float = 0.5
    audio_dropout: float = 0.5
    resnet_relu_type: str = "prelu"
    # train-time dropouts
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.1
    layerdrop: float = 0.0
    # switches of the JAX package's encoder (flash attention, layer-scan
    # unroll, "none"/"dots"/"full"/"ffn"/"ffn2"/"qkv_ffn" remat of the
    # encoder layer, remat of the video frontend); see avsr_tpu/core/config.py
    use_flash_attention: bool = False
    scan_unroll: int = 1
    scan_remat: str = "none"
    frontend_remat: bool = False

    @property
    def fused_dim(self) -> int:
        return (
            2 * self.encoder_embed_dim
            if self.modality_fuse == "concat"
            else self.encoder_embed_dim
        )


@dataclass
class AVHubertAVSRConfig:
    """Full E2E model: AVHubert encoder + CTC head + transformer decoder."""

    odim: int = 5049
    adim: int = 1024  # encoder output dim
    ddim: int = 1024  # decoder dim
    dheads: int = 16
    dunits: int = 3072
    dlayers: int = 6
    dropout_rate: float = 0.1
    transformer_attn_dropout_rate: float = 0.1
    lsm_weight: float = 0.1
    transformer_length_normalized_loss: bool = False
    mtlalpha: float = 0.1
    # decode-time KV cache storage dtype ('float32' | 'bfloat16')
    decoder_cache_dtype: str = "float32"
    # decode-path weight/activation dtype (bfloat16 for fast serving;
    # softmax and log-softmax stay fp32)
    decoder_param_dtype: str = "float32"
    # switches of the JAX package's decode step: fused self-attention (the
    # port's unfused step always runs its decode_attention kernel) and the
    # fused decoder layer (the port runs decoder_layer_step, one launch per
    # layer and step, when it is set)
    decode_fused_attention: bool = False
    decode_fused_layer: bool = False
    encoder: AVHubertEncoderConfig = field(default_factory=AVHubertEncoderConfig)

    @property
    def sos(self) -> int:
        return self.odim - 1

    @property
    def eos(self) -> int:
        return self.odim - 1

    @property
    def blank(self) -> int:
        return 0

    @property
    def ignore_id(self) -> int:
        return -1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AVHubertAVSRConfig":
        """Build from a (possibly reference-format) config.json dict."""
        enc_fields = {f.name for f in dataclasses.fields(AVHubertEncoderConfig)}
        top_fields = {f.name for f in dataclasses.fields(cls)} - {"encoder"}
        enc = AVHubertEncoderConfig(
            **{k: v for k, v in d.items() if k in enc_fields}
        )
        top = {k: v for k, v in d.items() if k in top_fields}
        return cls(encoder=enc, **top)

    @classmethod
    def from_json(cls, path: str) -> "AVHubertAVSRConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        enc = d.pop("encoder")
        d.update(enc)
        return d

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
