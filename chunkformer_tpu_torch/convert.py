"""Weights in and out of the port's state dict.

- ``load_state_dict``: read a reference ``pytorch_model.bin``.
- ``state_dict_from_jax_params``: the JAX package's parameter tree (as numpy
  arrays; layers stacked on axis 0) -> the port's state dict, with the
  reference names of ``chunkformer_tpu/export.py:51 params_to_torch_state_dict``
  (linear weights back to [out, in], conv weights as they are), the decoder,
  the classification heads and the transducer's predictor (all three types),
  joint and simple-joint projections included. It carries weights between the two
  packages without going through a file; being a map of names and layouts,
  it also carries a JAX gradient tree onto the port's parameter names.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import ChunkFormerConfig


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch .bin/.pt checkpoint (tensors only) onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_jax_params(params: Dict[str, Any],
                               cfg: ChunkFormerConfig) -> Dict[str, torch.Tensor]:
    """Encoder, CTC, decoder, classification-head and transducer parameters
    of a JAX model -> reference-named tensors (the transducer names of
    ``chunkformer_tpu/export.py:125-150`` and, for the embedding and conv
    predictors, the reference modules' own: ``pos_embed``, ``ffn``,
    ``conv``, ``norm``)."""
    sd: Dict[str, torch.Tensor] = {}

    def linear(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["w"]).T.contiguous()
        if "b" in p:
            sd[f"{prefix}.bias"] = _t(p["b"])

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["w"])
        if "b" in p:
            sd[f"{prefix}.bias"] = _t(p["b"])

    def norm(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        if "bias" in p:
            sd[f"{prefix}.bias"] = _t(p["bias"])
        if "mean" in p:
            sd[f"{prefix}.running_mean"] = _t(p["mean"])
            sd[f"{prefix}.running_var"] = _t(p["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    ep = params["encoder"]
    if "cmvn" in ep:
        sd["encoder.global_cmvn.mean"] = _t(ep["cmvn"]["mean"])
        sd["encoder.global_cmvn.istd"] = _t(ep["cmvn"]["istd"])
    conv("encoder.embed.conv.0", ep["embed"]["conv0"])
    for i, base in enumerate((2, 5), start=1):
        conv(f"encoder.embed.conv.{base}", ep["embed"][f"dw{i}"])
        conv(f"encoder.embed.conv.{base + 1}", ep["embed"][f"pw{i}"])
    linear("encoder.embed.out", ep["embed"]["out"])

    def layer_slice(tree, i):
        if isinstance(tree, dict):
            return {k: layer_slice(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    def n_layers(tree):
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return np.asarray(tree).shape[0]

    for i in range(cfg.encoder_conf.num_blocks):
        layer = layer_slice(ep["layers"], i)
        lp = f"encoder.encoders.{i}."
        sa = layer["self_attn"]
        for name, key in (("linear_q", "q"), ("linear_k", "k"), ("linear_v", "v"),
                          ("linear_out", "out"), ("linear_pos", "pos")):
            linear(f"{lp}self_attn.{name}", sa[key])
        sd[f"{lp}self_attn.pos_bias_u"] = _t(sa["pos_bias_u"])
        sd[f"{lp}self_attn.pos_bias_v"] = _t(sa["pos_bias_v"])
        linear(f"{lp}feed_forward.w_1", layer["ff"]["w1"])
        linear(f"{lp}feed_forward.w_2", layer["ff"]["w2"])
        norm(f"{lp}norm_ff", layer["norm_ff"])
        norm(f"{lp}norm_mha", layer["norm_mha"])
        if "ff_macaron" in layer:
            linear(f"{lp}feed_forward_macaron.w_1", layer["ff_macaron"]["w1"])
            linear(f"{lp}feed_forward_macaron.w_2", layer["ff_macaron"]["w2"])
            norm(f"{lp}norm_ff_macaron", layer["norm_ff_macaron"])
        if "conv" in layer:
            conv(f"{lp}conv_module.pointwise_conv1", layer["conv"]["pw1"])
            conv(f"{lp}conv_module.depthwise_conv", layer["conv"]["dw"])
            norm(f"{lp}conv_module.norm", layer["conv"]["norm"])
            conv(f"{lp}conv_module.pointwise_conv2", layer["conv"]["pw2"])
            norm(f"{lp}norm_conv", layer["norm_conv"])
            norm(f"{lp}norm_final", layer["norm_final"])
    norm("encoder.after_norm", ep["after_norm"])
    if "ctc" in params:
        linear("ctc.ctc_lo", params["ctc"]["lo"])
    for task, head in params.get("heads", {}).items():
        linear(f"classification_heads.{task}.linear", head["linear"])

    if "predictor" in params:
        pp = params["predictor"]
        sd["predictor.embed.weight"] = _t(pp["embed"]["w"])
        for i, lp in enumerate(pp.get("rnn", [])):
            for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                              ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                sd[f"predictor.rnn.{name}_l{i}"] = _t(lp[key])
        if "projection" in pp:
            linear("predictor.projection", pp["projection"])
        if "pos_embed" in pp:  # already torch's [n_head, embed * context]
            sd["predictor.pos_embed.weight"] = _t(pp["pos_embed"]["w"])
            linear("predictor.ffn", pp["ffn"])
        if "conv" in pp:
            conv("predictor.conv", pp["conv"])
        if "norm" in pp:
            norm("predictor.norm", pp["norm"])
    for name, key in (("enc_ffn", "enc_ffn"), ("pred_ffn", "pred_ffn"),
                      ("post_ffn", "post_ffn"), ("ffn_out", "ffn_out"),
                      ("blank_pred.2", "blank_pred"), ("token_pred.2", "token_pred")):
        if key in params.get("joint", {}):
            linear(f"joint.{name}", params["joint"][key])
    for name in ("simple_am_proj", "simple_lm_proj"):
        if name in params:
            linear(name, params[name])

    for side, name in (("left", "left_decoder"), ("right", "right_decoder")):
        if side not in params.get("decoder", {}):
            continue
        dp = params["decoder"][side]
        sp = f"decoder.{name}."
        sd[f"{sp}embed.0.weight"] = _t(dp["embed"]["w"])
        for i in range(n_layers(dp["layers"])):
            layer = layer_slice(dp["layers"], i)
            lp = f"{sp}decoders.{i}."
            for attn in ("self_attn", "src_attn"):
                for lin, key in (("linear_q", "q"), ("linear_k", "k"), ("linear_v", "v"),
                                 ("linear_out", "out")):
                    linear(f"{lp}{attn}.{lin}", layer[attn][key])
            linear(f"{lp}feed_forward.w_1", layer["ff"]["w1"])
            linear(f"{lp}feed_forward.w_2", layer["ff"]["w2"])
            for norm_name in ("norm1", "norm2", "norm3"):
                norm(f"{lp}{norm_name}", layer[norm_name])
        norm(f"{sp}after_norm", dp["after_norm"])
        if "output_layer" in dp:
            linear(f"{sp}output_layer", dp["output_layer"])
    return sd
