"""Reference state_dict <-> flax-layout variables, for both model families.

The port's models hold the upstream reference's state_dict layout. The JAX
package and its `.ckpt` checkpoints hold flax variables ({'params',
'batch_stats'} trees of numpy arrays). These functions carry weights
across, as pure layout changes (a copy of the tables in
video_fingerprint_tpu/utils/torch_compat.py); `state_dict_to_variables`
and `variables_to_state_dict` pick the table by the config's model_type:

  conv2d  torch (O,I,kh,kw)  <-> flax (kh,kw,I,O)
  conv3d  torch (O,I,kd,kh,kw) <-> flax (kd,kh,kw,I,O)
  conv1d  torch (O,I/g,k)    <-> flax (k,I/g,O)
  linear  torch (O,I)        <-> flax (I,O)
  conv1d k=1 used as pointwise <-> linear
  MHA in_proj_weight (3C,C)  <-> (C,3C)

TimeSformer, which the JAX package does not have, keeps its state dict
as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

import torch

from video_fingerprint_tpu_torch.models.layers import PE_MAX_LEN, _sinusoidal_table
from video_fingerprint_tpu_torch.training.optim import GROUP_FACTORS, param_group_label

_SPATIAL_INDICES = [(0, 1), (3, 4), (6, 7), (9, 10)]  # (conv, bn) in the Sequential


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _set(tree: Dict, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


def _get(tree, path: str) -> np.ndarray:
    node = tree
    for p in path.split("/"):
        node = node[p]
    return np.asarray(node)


def attention_state_dict_to_variables(sd: Mapping[str, np.ndarray]) -> Dict:
    """Reference VideoFingerprintAttention state_dict -> flax variables."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict = {}
    stats: Dict = {}

    def linear(torch_key, our_path):
        _set(params, f"{our_path}/dense/kernel", _t(sd[f"{torch_key}.weight"]))
        _set(params, f"{our_path}/dense/bias", sd[f"{torch_key}.bias"])

    def bn(torch_key, our_path):
        _set(params, f"{our_path}/scale", sd[f"{torch_key}.weight"])
        _set(params, f"{our_path}/bias", sd[f"{torch_key}.bias"])
        _set(stats, f"{our_path}/mean", sd[f"{torch_key}.running_mean"])
        _set(stats, f"{our_path}/var", sd[f"{torch_key}.running_var"])

    def pointwise(torch_key, our_path):
        _set(params, f"{our_path}/dense/kernel", _t(sd[f"{torch_key}.weight"][:, :, 0]))
        _set(params, f"{our_path}/dense/bias", sd[f"{torch_key}.bias"])

    for i, (conv_idx, bn_idx) in enumerate(_SPATIAL_INDICES):
        key = f"spatial_encoder.encoder.{conv_idx}"
        _set(params, f"spatial_encoder/conv{i}/conv/kernel",
             np.ascontiguousarray(np.transpose(sd[f"{key}.weight"], (2, 3, 1, 0))))
        _set(params, f"spatial_encoder/conv{i}/conv/bias", sd[f"{key}.bias"])
        bn(f"spatial_encoder.encoder.{bn_idx}", f"spatial_encoder/bn{i}")
    linear("spatial_encoder.encoder.14", "spatial_encoder/proj")
    linear("temporal_projection", "temporal_projection")

    for b in range(2):
        for j in range(4):
            tk = f"temporal_conv_blocks.{b}.convs.{j}"
            op = f"temporal_conv_blocks_{b}"
            _set(params, f"{op}/conv{j}/conv/kernel",
                 np.ascontiguousarray(np.transpose(sd[f"{tk}.0.weight"], (2, 1, 0))))
            _set(params, f"{op}/conv{j}/conv/bias", sd[f"{tk}.0.bias"])
            bn(f"{tk}.1", f"{op}/bn{j}")

    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("attention_blocks.")})
    for i in range(n_blocks):
        tk = f"attention_blocks.{i}"
        op = f"attention_blocks_{i}"
        for norm in ("norm1", "norm2"):
            _set(params, f"{op}/{norm}/scale", sd[f"{tk}.{norm}.weight"])
            _set(params, f"{op}/{norm}/bias", sd[f"{tk}.{norm}.bias"])
        _set(params, f"{op}/attn/in_proj_kernel", _t(sd[f"{tk}.attn.in_proj_weight"]))
        _set(params, f"{op}/attn/in_proj_bias", sd[f"{tk}.attn.in_proj_bias"])
        linear(f"{tk}.attn.out_proj", f"{op}/attn/out_proj")
        pointwise(f"{tk}.conv1", f"{op}/conv1")
        pointwise(f"{tk}.conv2", f"{op}/conv2")

    pointwise("temporal_pool.0", "temporal_pool")
    linear("final_projection.0", "final_projection_1")
    linear("final_projection.3", "final_projection_2")
    _set(params, "temperature", sd["temperature"])
    return {"params": params, "batch_stats": stats}


def attention_variables_to_state_dict(variables) -> Dict[str, np.ndarray]:
    """Flax variables -> reference state_dict layout (strict-loadable into
    the port's VideoFingerprintAttention and the reference model)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    def linear(our_path, torch_key):
        sd[f"{torch_key}.weight"] = _t(_get(params, f"{our_path}/dense/kernel"))
        sd[f"{torch_key}.bias"] = _get(params, f"{our_path}/dense/bias")

    def bn(our_path, torch_key):
        sd[f"{torch_key}.weight"] = _get(params, f"{our_path}/scale")
        sd[f"{torch_key}.bias"] = _get(params, f"{our_path}/bias")
        sd[f"{torch_key}.running_mean"] = _get(stats, f"{our_path}/mean")
        sd[f"{torch_key}.running_var"] = _get(stats, f"{our_path}/var")
        sd[f"{torch_key}.num_batches_tracked"] = np.asarray(0, np.int64)

    def pointwise(our_path, torch_key):
        sd[f"{torch_key}.weight"] = _t(_get(params, f"{our_path}/dense/kernel"))[:, :, None]
        sd[f"{torch_key}.bias"] = _get(params, f"{our_path}/dense/bias")

    for i, (conv_idx, bn_idx) in enumerate(_SPATIAL_INDICES):
        w = _get(params, f"spatial_encoder/conv{i}/conv/kernel")
        sd[f"spatial_encoder.encoder.{conv_idx}.weight"] = np.ascontiguousarray(
            np.transpose(w, (3, 2, 0, 1)))
        sd[f"spatial_encoder.encoder.{conv_idx}.bias"] = _get(
            params, f"spatial_encoder/conv{i}/conv/bias")
        bn(f"spatial_encoder/bn{i}", f"spatial_encoder.encoder.{bn_idx}")
    linear("spatial_encoder/proj", "spatial_encoder.encoder.14")
    linear("temporal_projection", "temporal_projection")

    for b in range(2):
        for j in range(4):
            op = f"temporal_conv_blocks_{b}"
            tk = f"temporal_conv_blocks.{b}.convs.{j}"
            w = _get(params, f"{op}/conv{j}/conv/kernel")  # (k, in/g, out)
            sd[f"{tk}.0.weight"] = np.ascontiguousarray(np.transpose(w, (2, 1, 0)))
            sd[f"{tk}.0.bias"] = _get(params, f"{op}/conv{j}/conv/bias")
            bn(f"{op}/bn{j}", f"{tk}.1")

    n_blocks = len([k for k in params if k.startswith("attention_blocks_")])
    for i in range(n_blocks):
        op = f"attention_blocks_{i}"
        tk = f"attention_blocks.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{tk}.{norm}.weight"] = _get(params, f"{op}/{norm}/scale")
            sd[f"{tk}.{norm}.bias"] = _get(params, f"{op}/{norm}/bias")
        sd[f"{tk}.attn.in_proj_weight"] = _t(_get(params, f"{op}/attn/in_proj_kernel"))
        sd[f"{tk}.attn.in_proj_bias"] = _get(params, f"{op}/attn/in_proj_bias")
        linear(f"{op}/attn/out_proj", f"{tk}.attn.out_proj")
        pointwise(f"{op}/conv1", f"{tk}.conv1")
        pointwise(f"{op}/conv2", f"{tk}.conv2")

    pointwise("temporal_pool", "temporal_pool.0")
    linear("final_projection_1", "final_projection.0")
    linear("final_projection_2", "final_projection.3")
    sd["temperature"] = _get(params, "temperature")

    # the reference registers the sinusoidal table as a persistent buffer
    temporal_dim = _get(params, "temporal_projection/dense/kernel").shape[1]
    sd["pos_encoding.pe"] = _sinusoidal_table(PE_MAX_LEN, temporal_dim)[None].copy()
    return sd


def cnn3d_state_dict_to_variables(sd: Mapping[str, np.ndarray]) -> Dict:
    """Reference VideoFingerprint3D state_dict -> flax variables."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict = {}
    stats: Dict = {}
    for i in range(4):  # Conv3DBlocks at encoder indices 0..3
        tk, op = f"encoder.{i}", f"block{i}"
        _set(params, f"{op}/conv/conv/kernel",
             np.ascontiguousarray(np.transpose(sd[f"{tk}.conv.weight"], (2, 3, 4, 1, 0))))
        _set(params, f"{op}/conv/conv/bias", sd[f"{tk}.conv.bias"])
        _set(params, f"{op}/bn/scale", sd[f"{tk}.bn.weight"])
        _set(params, f"{op}/bn/bias", sd[f"{tk}.bn.bias"])
        _set(stats, f"{op}/bn/mean", sd[f"{tk}.bn.running_mean"])
        _set(stats, f"{op}/bn/var", sd[f"{tk}.bn.running_var"])
    for name in ("temporal_conv", "temporal_attention"):
        _set(params, f"{name}/conv/kernel",
             np.ascontiguousarray(np.transpose(sd[f"{name}.weight"], (2, 1, 0))))
        _set(params, f"{name}/conv/bias", sd[f"{name}.bias"])
    for torch_key, our in (("projector.0", "projector_1"), ("projector.3", "projector_2")):
        _set(params, f"{our}/dense/kernel", _t(sd[f"{torch_key}.weight"]))
        _set(params, f"{our}/dense/bias", sd[f"{torch_key}.bias"])
    _set(params, "temperature", sd["temperature"])
    return {"params": params, "batch_stats": stats}


def cnn3d_variables_to_state_dict(variables) -> Dict[str, np.ndarray]:
    """Flax variables -> reference VideoFingerprint3D state_dict layout."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for i in range(4):
        op, tk = f"block{i}", f"encoder.{i}"
        w = _get(params, f"{op}/conv/conv/kernel")  # (kd, kh, kw, in, out)
        sd[f"{tk}.conv.weight"] = np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2)))
        sd[f"{tk}.conv.bias"] = _get(params, f"{op}/conv/conv/bias")
        sd[f"{tk}.bn.weight"] = _get(params, f"{op}/bn/scale")
        sd[f"{tk}.bn.bias"] = _get(params, f"{op}/bn/bias")
        sd[f"{tk}.bn.running_mean"] = _get(stats, f"{op}/bn/mean")
        sd[f"{tk}.bn.running_var"] = _get(stats, f"{op}/bn/var")
        sd[f"{tk}.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    for name in ("temporal_conv", "temporal_attention"):
        w = _get(params, f"{name}/conv/kernel")  # (k, in, out)
        sd[f"{name}.weight"] = np.ascontiguousarray(np.transpose(w, (2, 1, 0)))
        sd[f"{name}.bias"] = _get(params, f"{name}/conv/bias")
    for our, torch_key in (("projector_1", "projector.0"), ("projector_2", "projector.3")):
        sd[f"{torch_key}.weight"] = _t(_get(params, f"{our}/dense/kernel"))
        sd[f"{torch_key}.bias"] = _get(params, f"{our}/dense/bias")
    sd["temperature"] = _get(params, "temperature")
    return sd


def state_dict_to_variables(sd: Mapping[str, np.ndarray], model_type: str) -> Dict:
    """The JAX package's variables of a state dict. TimeSformer has no JAX
    model: its variables hold the state dict as it is, under 'params', keyed
    by `transformers`' TimesformerModel names."""
    if model_type == "attention":
        return attention_state_dict_to_variables(sd)
    if model_type in ("3d", "cnn3d"):
        return cnn3d_state_dict_to_variables(sd)
    if model_type == "timesformer":
        return {"params": {k: np.asarray(v) for k, v in sd.items()}, "batch_stats": {}}
    raise ValueError(f"Unknown model type: {model_type}")


def variables_to_state_dict(variables, model_type: str) -> Dict[str, np.ndarray]:
    if model_type == "attention":
        return attention_variables_to_state_dict(variables)
    if model_type in ("3d", "cnn3d"):
        return cnn3d_variables_to_state_dict(variables)
    if model_type == "timesformer":
        return {k: np.asarray(v) for k, v in variables["params"].items()}
    raise ValueError(f"Unknown model type: {model_type}")


# --------------------------------------------------------------------------
# AdamW state <-> optax state dict
#
# The JAX package's optimizer is optax.chain(clip_by_global_norm, adamw) —
# for the attention model with the adamw inside a multi_transform over the
# spatial / attention / other labels. flax.serialization.to_state_dict of
# its state is, with "count" an int32 scalar (the updates done) and mu / nu
# params-shaped trees of the first and second moments:
#
#   3D:        {"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {},
#                              "2": {"count"}}}
#   attention: {"0": {}, "1": {"inner_states": {label: {"inner_state":
#                 {"0": {"count", "mu", "nu"}, "1": {}, "2": {"count"}}}}}}
#
# where a label's mu / nu hold {} in place of every leaf of another label.
# The moments carry over through the same tables as the weights, so every
# kernel is transposed exactly as its parameter.

def _emptied(tree):
    return {k: _emptied(v) for k, v in tree.items()} if isinstance(tree, dict) else {}


def _merge(trees):
    """Leaf-wise union of trees whose leaves are {} where absent."""
    out = {}
    for key in trees[0]:
        subs = [t[key] for t in trees]
        if all(isinstance(s, dict) for s in subs):
            merged = _merge(subs)
            out[key] = merged
        else:
            out[key] = next(s for s in subs if not isinstance(s, dict))
    return out


def _named_state_dict(model, values: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The model's state_dict with `values` in place of its parameters."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    sd.update(values)
    return sd


def adamw_to_opt_state(optimizer, model, model_type: str) -> Dict:
    """torch AdamW state (exp_avg, exp_avg_sq, step) -> the optax state dict
    of the JAX package's optimizer for the same model."""
    names = {p: n for n, p in model.named_parameters()}
    mu, nu, count = {}, {}, 0
    for p, name in names.items():
        state = optimizer.state.get(p, {})
        zeros = np.zeros(tuple(p.shape), np.float32)
        mu[name] = state["exp_avg"].detach().cpu().numpy() if state else zeros
        nu[name] = state["exp_avg_sq"].detach().cpu().numpy() if state else zeros
        if state:
            count = int(state["step"])
    mu_tree = state_dict_to_variables(_named_state_dict(model, mu), model_type)["params"]
    nu_tree = state_dict_to_variables(_named_state_dict(model, nu), model_type)["params"]
    c = np.asarray(count, np.int32)

    def adam(m, v):
        return {"0": {"count": c, "mu": m, "nu": v}, "1": {}, "2": {"count": c}}

    if model_type != "attention":
        return {"0": {}, "1": adam(mu_tree, nu_tree)}

    def only(tree, label):
        return {k: (v if param_group_label(k) == label else _emptied(v))
                for k, v in tree.items()}

    return {"0": {}, "1": {"inner_states": {
        label: {"inner_state": adam(only(mu_tree, label), only(nu_tree, label))}
        for label in GROUP_FACTORS}}}


def opt_state_to_adamw(opt_state: Mapping, optimizer, model, model_type: str) -> int:
    """Load an optax state dict of the JAX package's optimizer into torch
    AdamW's state for the same model; returns the update count."""
    if model_type == "attention":
        inner = [opt_state["1"]["inner_states"][label]["inner_state"]["0"]
                 for label in GROUP_FACTORS]
        mu_tree = _merge([s["mu"] for s in inner])
        nu_tree = _merge([s["nu"] for s in inner])
        count = int(inner[0]["count"])
    else:
        adam = opt_state["1"]["0"]
        mu_tree, nu_tree, count = adam["mu"], adam["nu"], int(adam["count"])
    stats = state_dict_to_variables(_named_state_dict(model, {}), model_type)["batch_stats"]
    mu = variables_to_state_dict({"params": mu_tree, "batch_stats": stats}, model_type)
    nu = variables_to_state_dict({"params": nu_tree, "batch_stats": stats}, model_type)
    optimizer.state.clear()
    if count == 0:
        return 0
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(mu[name], dtype=p.dtype).to(p.device).reshape(p.shape),
            "exp_avg_sq": torch.as_tensor(nu[name], dtype=p.dtype).to(p.device).reshape(p.shape),
        }
    return count
