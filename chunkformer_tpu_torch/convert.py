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

import re
from typing import Any, Dict, Optional, Tuple

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


# port module prefix -> (JAX path, kind); "{0}", "{1}" take the regex's
# groups, and a group named "layer" is the index on the JAX leaves' stacked
# layer axis. Kinds map the leaf names: linear weight -> w (transposed),
# bias -> b; conv weight -> w, bias -> b; norm weight -> scale, bias,
# running_mean -> mean, running_var -> var; raw weight -> w, others as named.
_EMBED_CONVS = {"0": "conv0", "2": "dw1", "3": "pw1", "5": "dw2", "6": "pw2"}
_LAYOUT = [
    (r"encoder\.global_cmvn", "encoder/cmvn", "raw"),
    (r"encoder\.embed\.conv\.(\d)", "encoder/embed/{conv}", "conv"),
    (r"encoder\.embed\.out", "encoder/embed/out", "linear"),
    (r"encoder\.encoders\.(?P<layer>\d+)\.self_attn\.linear_(q|k|v|out|pos)",
     "encoder/layers/self_attn/{1}", "linear"),
    (r"encoder\.encoders\.(?P<layer>\d+)\.self_attn", "encoder/layers/self_attn", "raw"),
    (r"encoder\.encoders\.(?P<layer>\d+)\.feed_forward(_macaron)?\.w_([12])",
     "encoder/layers/ff{1}/w{2}", "linear"),
    (r"encoder\.encoders\.(?P<layer>\d+)\.conv_module\.pointwise_conv1",
     "encoder/layers/conv/pw1", "conv"),
    (r"encoder\.encoders\.(?P<layer>\d+)\.conv_module\.depthwise_conv",
     "encoder/layers/conv/dw", "conv"),
    (r"encoder\.encoders\.(?P<layer>\d+)\.conv_module\.pointwise_conv2",
     "encoder/layers/conv/pw2", "conv"),
    (r"encoder\.encoders\.(?P<layer>\d+)\.conv_module\.norm", "encoder/layers/conv/norm",
     "norm"),
    (r"encoder\.encoders\.(?P<layer>\d+)\.(norm_\w+)", "encoder/layers/{1}", "norm"),
    (r"encoder\.after_norm", "encoder/after_norm", "norm"),
    (r"ctc\.ctc_lo", "ctc/lo", "linear"),
    (r"classification_heads\.(\w+)\.linear", "heads/{0}/linear", "linear"),
    (r"predictor\.rnn", "predictor/rnn", "rnn"),
    (r"predictor\.(embed|pos_embed)", "predictor/{0}", "raw"),
    (r"predictor\.(projection|ffn)", "predictor/{0}", "linear"),
    (r"predictor\.conv", "predictor/conv", "conv"),
    (r"predictor\.norm", "predictor/norm", "norm"),
    (r"joint\.(enc_ffn|pred_ffn|post_ffn|ffn_out)", "joint/{0}", "linear"),
    (r"joint\.(blank_pred|token_pred)\.2", "joint/{0}", "linear"),
    (r"(simple_am_proj|simple_lm_proj)", "{0}", "linear"),
    (r"decoder\.(left|right)_decoder\.embed\.0", "decoder/{0}/embed", "raw"),
    (r"decoder\.(left|right)_decoder\.decoders\.(?P<layer>\d+)\.(self_attn|src_attn)"
     r"\.linear_(q|k|v|out)", "decoder/{0}/layers/{2}/{3}", "linear"),
    (r"decoder\.(left|right)_decoder\.decoders\.(?P<layer>\d+)\.feed_forward\.w_([12])",
     "decoder/{0}/layers/ff/w{2}", "linear"),
    (r"decoder\.(left|right)_decoder\.decoders\.(?P<layer>\d+)\.(norm[123])",
     "decoder/{0}/layers/{2}", "norm"),
    (r"decoder\.(left|right)_decoder\.after_norm", "decoder/{0}/after_norm", "norm"),
    (r"decoder\.(left|right)_decoder\.output_layer", "decoder/{0}/output_layer", "linear"),
]
_LEAVES = {"linear": {"weight": "w", "bias": "b"}, "conv": {"weight": "w", "bias": "b"},
           "norm": {"weight": "scale", "bias": "bias", "running_mean": "mean",
                    "running_var": "var"}}


def jax_layout(names) -> Dict[str, Tuple[Tuple, Optional[int], bool]]:
    """Where each port state-dict entry sits in the JAX package's parameter
    tree, the inverse of ``state_dict_from_jax_params``: name -> (JAX path,
    index on the leaf's stacked layer axis or None, transposed). The JAX
    tree holds no counterpart of ``num_batches_tracked``, which is left out;
    any other unknown name raises."""
    out = {}
    for name in names:
        prefix, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        for pattern, path, kind in _LAYOUT:
            m = re.fullmatch(pattern, prefix)
            if m:
                break
        else:
            raise KeyError(f"no JAX counterpart for {name}")
        groups = [g or "" for g in m.groups()]
        layer = m.groupdict().get("layer")
        parts = tuple(path.format(*groups, conv=_EMBED_CONVS.get(groups[0] if groups else "",
                                                                 "")).split("/"))
        if kind == "rnn":  # weight_ih_l0 -> rnn[0]["w_ih"]
            gate, ih, idx = re.fullmatch(r"(weight|bias)_(ih|hh)_l(\d+)", leaf).groups()
            out[name] = (parts + (int(idx), f"{gate[0]}_{ih}"), None, False)
            continue
        key = _LEAVES.get(kind, {"weight": "w"}).get(leaf, leaf)
        out[name] = (parts + (key,), None if layer is None else int(layer),
                     kind == "linear" and leaf == "weight")
    return out


def jax_leaf_order(paths):
    """The JAX paths in ``jax.tree`` leaf order: dict keys sorted, list items
    in order (a node's children are all names or all list indices)."""
    return sorted(set(paths))
