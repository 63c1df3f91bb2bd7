"""Configuration dataclasses for the PyTorch port.

A copy of ``chunkformer_tpu/config.py``: the reference ``config.yaml`` /
``train.yaml`` schema (encoder_conf, decoder_conf, ctc_conf, model_conf,
predictor_conf, joint_conf, output_dim, cmvn_conf, dataset_conf,
classification_conf) loads unmodified; unknown keys are ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kwargs.items() if k in names}


@dataclass
class EncoderConfig:
    """ChunkFormer encoder hyperparameters (reference: modules/encoder.py:36-92)."""

    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 12
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.0
    input_layer: str = "dw_striding"
    pos_enc_layer_type: str = "chunk_rel_pos"
    normalize_before: bool = True
    final_norm: bool = True
    norm_eps: float = 1e-5
    layer_norm_type: str = "layer_norm"
    macaron_style: bool = True
    activation_type: str = "swish"
    use_cnn_module: bool = True
    cnn_module_kernel: int = 15
    cnn_module_norm: str = "batch_norm"
    causal: bool = False
    dynamic_conv: bool = False
    selfattention_layer_type: str = "chunk_rel_seflattn"
    gradient_checkpointing: bool = False
    # under gradient_checkpointing: "nothing" recomputes each layer in the
    # backward; "dots" keeps the matrix products' and the training attention
    # kernel's outputs and recomputes the rest
    remat_policy: str = "nothing"
    dynamic_chunk_sizes: Optional[List[int]] = None
    dynamic_left_context_sizes: Optional[List[int]] = None
    dynamic_right_context_sizes: Optional[List[int]] = None
    streaming: bool = False
    subsampling_rate: int = 8
    max_pos_len: int = 5000

    @property
    def head_dim(self) -> int:
        return self.output_size // self.attention_heads

    @property
    def conv_lorder(self) -> int:
        return self.cnn_module_kernel // 2


@dataclass
class DecoderConfig:
    """AED decoder hyperparameters (reference: modules/decoder.py:35-172)."""

    decoder_type: str = "bitransformer"  # "transformer" | "bitransformer"
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 3
    r_num_blocks: int = 3
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    self_attention_dropout_rate: float = 0.0
    src_attention_dropout_rate: float = 0.0
    input_layer: str = "embed"
    use_output_layer: bool = True
    normalize_before: bool = True
    src_attention: bool = True
    tie_word_embedding: bool = False


@dataclass
class CTCConfig:
    ctc_blank_id: int = 0


@dataclass
class ModelConfig:
    """Hybrid loss weights (reference: modules/asr_model.py:28-76)."""

    ctc_weight: float = 0.3
    lsm_weight: float = 0.1
    length_normalized_loss: bool = False
    reverse_weight: float = 0.0
    # transducer extras (reference: transducer/transducer.py:24-97)
    transducer_weight: float = 0.75
    attention_weight: float = 0.1
    # banded (pruned) RNN-T loss
    use_pruned_loss: bool = False
    prune_range: int = 5
    # k2-style smoothed simple loss + posterior-pruned loss with warmup mixing
    # (reference: transducer/transducer.py:44-47,74-79,487-551)
    enable_k2: bool = False
    lm_only_scale: float = 0.25
    am_only_scale: float = 0.0
    delay_penalty: float = 0.0
    warmup_steps: int = 25000


@dataclass
class PredictorConfig:
    """RNN-T predictor (reference: transducer/predictor.py)."""

    predictor_type: str = "rnn"  # rnn | embedding | conv
    embed_size: int = 256
    output_size: int = 256
    hidden_size: int = 256
    embed_dropout: float = 0.1
    num_layers: int = 1
    bias: bool = True
    dropout: float = 0.1
    # embedding and conv predictors
    n_head: int = 4
    history_size: int = 2
    activation: str = "swish"


@dataclass
class JointConfig:
    """RNN-T joint network (reference: transducer/joint.py:9-68)."""

    join_dim: int = 512
    enc_output_size: int = 256
    pred_output_size: int = 256
    prejoin_linear: bool = True
    postjoin_linear: bool = False
    joint_mode: str = "add"
    activation: str = "tanh"
    hat_joint: bool = False


@dataclass
class ChunkFormerConfig:
    """Top-level config = parsed config.yaml."""

    model: str = "asr_model"  # asr_model | transducer | classification
    encoder: str = "chunkformer"
    encoder_conf: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: Optional[str] = None
    decoder_conf: Optional[DecoderConfig] = None
    ctc_conf: CTCConfig = field(default_factory=CTCConfig)
    model_conf: ModelConfig = field(default_factory=ModelConfig)
    predictor: Optional[str] = None
    predictor_conf: Optional[PredictorConfig] = None
    joint_conf: Optional[JointConfig] = None
    vocab_size: int = 0
    cmvn: Optional[str] = None
    cmvn_conf: Dict[str, Any] = field(default_factory=dict)
    tokenizer: str = "char"
    tokenizer_conf: Dict[str, Any] = field(default_factory=dict)
    dataset_conf: Dict[str, Any] = field(default_factory=dict)
    # classification: {"tasks": {name: num_classes}, "head_dropout": rate}
    classification_conf: Dict[str, Any] = field(default_factory=dict)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChunkFormerConfig":
        enc = EncoderConfig(**_filter_kwargs(EncoderConfig, d.get("encoder_conf", {}) or {}))
        if "input_dim" in d:
            enc.input_size = d["input_dim"]
        dec = None
        if d.get("decoder"):
            dc = dict(d.get("decoder_conf", {}) or {})
            dc["decoder_type"] = d["decoder"]
            dec = DecoderConfig(**_filter_kwargs(DecoderConfig, dc))
        pred = None
        if d.get("predictor"):
            pc = dict(d.get("predictor_conf", {}) or {})
            pc["predictor_type"] = d["predictor"]
            pred = PredictorConfig(**_filter_kwargs(PredictorConfig, pc))
        mc_raw = dict(d.get("model_conf", {}) or {})
        # reference schema: k2 pruned loss flag (transducer.py:504-542)
        if mc_raw.get("enable_k2", False):
            mc_raw.setdefault("use_pruned_loss", True)
        # reference schema: classification tasks live under model_conf
        # (examples/classification/conf/multi_task.yaml)
        classification_conf = dict(d.get("classification_conf", {}) or {})
        if "tasks" in mc_raw:
            classification_conf.setdefault("tasks", mc_raw.pop("tasks"))
        if d.get("model") == "classification":
            classification_conf.setdefault("head_dropout", mc_raw.get("dropout_rate", 0.1))
            if "label_smoothing" in mc_raw:
                mc_raw.setdefault("lsm_weight", mc_raw.pop("label_smoothing"))
        joint = None
        if "joint_conf" in d or d.get("model") == "transducer":
            jc = dict(d.get("joint_conf", {}) or {})
            jc.setdefault("enc_output_size", enc.output_size)
            joint = JointConfig(**_filter_kwargs(JointConfig, jc))
        return cls(
            model=d.get("model", "asr_model"),
            encoder=d.get("encoder", "chunkformer"),
            encoder_conf=enc,
            decoder=d.get("decoder"),
            decoder_conf=dec,
            ctc_conf=CTCConfig(**_filter_kwargs(CTCConfig, d.get("ctc_conf", {}) or {})),
            model_conf=ModelConfig(**_filter_kwargs(ModelConfig, mc_raw)),
            predictor=d.get("predictor"),
            predictor_conf=pred,
            joint_conf=joint,
            vocab_size=d.get("output_dim", d.get("vocab_size", 0)),
            cmvn=d.get("cmvn"),
            cmvn_conf=d.get("cmvn_conf", {}) or {},
            tokenizer=d.get("tokenizer", "char"),
            tokenizer_conf=d.get("tokenizer_conf", {}) or {},
            dataset_conf=d.get("dataset_conf", {}) or {},
            classification_conf=classification_conf,
            raw=d,
        )

    @classmethod
    def from_yaml(cls, path: str) -> "ChunkFormerConfig":
        import yaml  # only this path needs PyYAML

        with open(path, "r") as f:
            return cls.from_dict(yaml.safe_load(f))


def override_config(d: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply `a.b.c value` dot-path overrides (reference: utils/config.py:18-39)."""
    import yaml

    for item in overrides:
        key, value = item.split(maxsplit=1)
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    return d
