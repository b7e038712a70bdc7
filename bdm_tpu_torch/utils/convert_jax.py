"""JAX parameter trees (numpy leaves) -> `bdm_tpu_torch` state_dicts.

The inverse of `bdm_tpu/utils/convert_torch.py`: it produces the reference
checkpoints' keys, which the port's modules use, so a tree converted here,
loaded into the port and sent back through `convert_torch` is bit-identical
to the original. Layout rules (flax -> torch):

  Dense kernel (in, out)            -> weight (out, in), or (out, in, 1...)
  Conv kernel (3, 3, 3, in, out)    -> weight (out, in, 3, 3, 3)
  patch embed (p, p, 3, D)          -> weight (D, 3, p, p)
  MHA query/key/value (D, H, Dh)    -> rows of the fused qkv (3D, D)
  GroupNorm / LayerNorm scale       -> weight
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from bdm_tpu_torch.models.pvcnn import PVCNN2Specs


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])


def _norm(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _shared_mlp(out: Dict, prefix: str, p: Dict) -> None:
    j = 0
    while f"conv{j}" in p:
        _dense(out, f"{prefix}.layers.{3 * j}", p[f"conv{j}"])
        _norm(out, f"{prefix}.layers.{3 * j + 1}", p[f"norm{j}"])
        j += 1


def _attention(out: Dict, prefix: str, p: Dict) -> None:
    for name in ("q", "k", "v", "out"):
        _dense(out, f"{prefix}.{name}", p[name])
    _norm(out, f"{prefix}.norm", p["norm"])


def _conv3d(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(_np(p["kernel"]), (4, 3, 0, 1, 2)))
    out[f"{prefix}.bias"] = _np(p["bias"])


def _pvconv(out: Dict, prefix: str, p: Dict) -> None:
    _conv3d(out, f"{prefix}.voxel_layers.0", p["vconv0"])
    _norm(out, f"{prefix}.voxel_layers.1", p["vnorm0"])
    _conv3d(out, f"{prefix}.voxel_layers.4", p["vconv1"])
    _norm(out, f"{prefix}.voxel_layers.5", p["vnorm1"])
    if "vatt" in p:
        _attention(out, f"{prefix}.voxel_layers.6", p["vatt"])
    out[f"{prefix}.voxel_layers.7.fc.0.weight"] = np.ascontiguousarray(
        _np(p["se"]["fc1"]["kernel"]).T)
    out[f"{prefix}.voxel_layers.7.fc.2.weight"] = np.ascontiguousarray(
        _np(p["se"]["fc2"]["kernel"]).T)
    _shared_mlp(out, f"{prefix}.point_features", p["point_features"])


def _encoder(out: Dict, enc: Dict, specs: PVCNN2Specs, sa_key: str,
             att_key: str) -> None:
    """A JAX PVCNNEncoder tree -> `<sa_key>.*` and `<att_key>.*`."""
    for i, stage in enumerate(specs.sa_stages):
        base = f"{sa_key}.{i}"
        for k in range(len(stage.convs)):
            _pvconv(out, f"{base}.{k}", enc[f"sa{i}_conv{k}"])
        sa = f"{base}.{len(stage.convs)}" if stage.convs else base
        _shared_mlp(out, f"{sa}.mlps.0", enc[f"sa{i}_pool"]["mlp"])
    if "global_att" in enc:
        _attention(out, att_key, enc["global_att"])


def _decoder(out: Dict, dec: Dict, specs: PVCNN2Specs, fp_key: str,
             classifier_key: str) -> None:
    """A JAX PVCNNDecoder tree -> `<fp_key>.*` and `<classifier_key>.*`."""
    for i, stage in enumerate(specs.fp_stages):
        base = f"{fp_key}.{i}"
        _shared_mlp(out, f"{base}.0.mlp", dec[f"fp{i}_mlp"]["mlp"])
        for k in range(len(stage.convs)):
            _pvconv(out, f"{base}.{k + 1}", dec[f"fp{i}_conv{k}"])
    _shared_mlp(out, f"{classifier_key}.0", dec["classifier_mlp"])
    _dense(out, f"{classifier_key}.2", dec["classifier_out"])


def _embedf(out: Dict, prefix: str, p: Dict) -> None:
    _dense(out, f"{prefix}.0", p["fc1"])
    _dense(out, f"{prefix}.2", p["fc2"])


def pvcnn2_state_dict(params: Dict, specs: PVCNN2Specs,
                      prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX PVCNN2 tree ({'params': ...} or its inside) -> reference keys
    (PC2 and PVD backbones alike)."""
    p = params.get("params", params)
    pre = f"{prefix}." if prefix else ""
    out: Dict[str, np.ndarray] = {}
    _embedf(out, f"{pre}embedf", p["embedf"])
    _encoder(out, p["encoder"], specs, f"{pre}sa_layers", f"{pre}global_att")
    _decoder(out, p["decoder"], specs, f"{pre}fp_layers", f"{pre}classifier")
    return out


def fusion_state_dict(params: Dict, pc2_specs: PVCNN2Specs,
                      pvd_specs: PVCNN2Specs,
                      prefix: str = "fusion_model.model"
                      ) -> Dict[str, np.ndarray]:
    """A JAX PVCNNFuse tree -> the reference fusion checkpoint's keys, as
    `bdm_tpu.utils.convert_torch.convert_fusion_checkpoint` reads them."""
    p = params.get("params", params)
    pre = f"{prefix}." if prefix else ""
    out: Dict[str, np.ndarray] = {}
    _embedf(out, f"{pre}embedf", p["embedf"])
    _encoder(out, p["pc2_encoder"], pc2_specs, f"{pre}pc2_model_sa_layers",
             f"{pre}pc2_model_global_att")
    _encoder(out, p["pvd_encoder"], pvd_specs, f"{pre}pvd_model_sa_layers",
             f"{pre}pvd_model_global_att")
    _decoder(out, p["decoder"], pc2_specs, f"{pre}fusion_decoder_fp_layers",
             f"{pre}classifier")
    i = 0
    while f"proj{i}" in p:
        for name, slot in (("conv1", 0), ("conv2", 2), ("zero_conv", 3)):
            _dense(out, f"{pre}projs.{i}.{slot}", p[f"proj{i}"][name])
        i += 1
    return out


def vit_state_dict(vit: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX VisionTransformer tree (the `vit` subtree) -> timm keys."""
    pre = f"{prefix}." if prefix else ""
    out: Dict[str, np.ndarray] = {
        f"{pre}cls_token": _np(vit["cls_token"]),
        f"{pre}pos_embed": _np(vit["pos_embed"]),
        f"{pre}patch_embed.proj.weight": np.ascontiguousarray(
            np.transpose(_np(vit["patch_embed"]["kernel"]), (3, 2, 0, 1))),
        f"{pre}patch_embed.proj.bias": _np(vit["patch_embed"]["bias"]),
    }
    _norm(out, f"{pre}norm", vit["norm"])
    i = 0
    while f"block{i}" in vit:
        blk, b = vit[f"block{i}"], f"{pre}blocks.{i}"
        _norm(out, f"{b}.norm1", blk["norm1"])
        _norm(out, f"{b}.norm2", blk["norm2"])
        att = blk["attn"]
        d = _np(att["query"]["kernel"]).shape[0]
        out[f"{b}.attn.qkv.weight"] = np.concatenate(
            [_np(att[n]["kernel"]).reshape(d, d).T
             for n in ("query", "key", "value")], axis=0)
        out[f"{b}.attn.qkv.bias"] = np.concatenate(
            [_np(att[n]["bias"]).reshape(d) for n in ("query", "key",
                                                      "value")])
        out[f"{b}.attn.proj.weight"] = np.ascontiguousarray(
            _np(att["out"]["kernel"]).reshape(d, d).T)
        out[f"{b}.attn.proj.bias"] = _np(att["out"]["bias"])
        _dense(out, f"{b}.mlp.fc1", blk["mlp"]["fc1"])
        _dense(out, f"{b}.mlp.fc2", blk["mlp"]["fc2"])
        i += 1
    return out


def simple_state_dict(params: Dict, prefix: str = ""
                      ) -> Dict[str, np.ndarray]:
    """A JAX SimplePointModel tree -> the port's keys (the JAX module
    names; the reference has no checkpoint of it)."""
    p = params.get("params", params)
    pre = f"{prefix}." if prefix else ""
    out: Dict[str, np.ndarray] = {}
    _embedf(out, f"{pre}embedf", p["embedf"])
    _dense(out, f"{pre}input_projection", p["input_projection"])
    i = 0
    while f"block{i}" in p:
        blk, b = p[f"block{i}"], f"{pre}blocks.{i}"
        _norm(out, f"{b}.norm", blk["norm"])
        for name in ("proj_in", "gate", "proj_out"):
            _dense(out, f"{b}.{name}", blk[name])
        i += 1
    _norm(out, f"{pre}final_norm", p["final_norm"])
    _dense(out, f"{pre}output_projection", p["output_projection"])
    return out


def pvcnn2pp_state_dict(params: Dict, specs: PVCNN2Specs, prefix: str = ""
                        ) -> Dict[str, np.ndarray]:
    """A JAX PVCNN2PlusPlus tree -> `simple.*`, `pvcnn.*` (the reference
    PVCNN2 keys; `specs` are the inner PVCNN2's), `head_fc.*`,
    `output_projection.*`."""
    p = params.get("params", params)
    pre = f"{prefix}." if prefix else ""
    out = simple_state_dict(p["simple"], f"{pre}simple")
    out.update(pvcnn2_state_dict(p["pvcnn"], specs, f"{pre}pvcnn"))
    _dense(out, f"{pre}head_fc", p["head_fc"])
    _dense(out, f"{pre}output_projection", p["output_projection"])
    return out


def pc2_state_dict(params: Dict, specs: Optional[PVCNN2Specs],
                   point_cloud_model: str = "pvcnn"
                   ) -> Dict[str, np.ndarray]:
    """JAX PC2 params {'feature_model', 'point_cloud_model'} -> the
    reference PC2 keys (`point_cloud_model.model.*`,
    `feature_model.model.*`), at any channel accounting (the shapes come
    from the tree), for the backbone `point_cloud_model` ("pvcnn",
    "simple" or "pvcnnplusplus"); `specs` are the PVCNN2's, PVCNN2++'s
    inner one's, or None for the simple backbone."""
    pcm, pre = params["point_cloud_model"], "point_cloud_model.model"
    if point_cloud_model == "pvcnn":
        out = pvcnn2_state_dict(pcm, specs, pre)
    elif point_cloud_model == "simple":
        out = simple_state_dict(pcm, pre)
    elif point_cloud_model == "pvcnnplusplus":
        out = pvcnn2pp_state_dict(pcm, specs, pre)
    else:
        raise NotImplementedError(point_cloud_model)
    fm = params.get("feature_model", {})
    fm = fm.get("params", fm)
    if "vit" in fm:
        out.update(vit_state_dict(fm["vit"], "feature_model.model"))
    return out


def coloring_state_dict(params: Dict, specs: PVCNN2Specs
                        ) -> Dict[str, np.ndarray]:
    """JAX colouring params {'feature_model', 'point_cloud_model'} (or a
    gradient tree of them) -> the port's keys, the JAX module names
    (`point_cloud_model.input_projection`, `.block{i}.norm0`, `.pvcnn.*`
    with the reference PVCNN2 keys, `.norm2`, `.mlp_fc1`, `.mlp_fc2`,
    `.output_projection`; `feature_model.model.*`); `specs` are the
    blocks' inner PVCNN2's. The reference has no colouring checkpoint
    layout."""
    pcm = params["point_cloud_model"]
    p, pre = pcm.get("params", pcm), "point_cloud_model"
    out: Dict[str, np.ndarray] = {}
    _dense(out, f"{pre}.input_projection", p["input_projection"])
    i = 0
    while f"block{i}" in p:
        blk, b = p[f"block{i}"], f"{pre}.block{i}"
        _norm(out, f"{b}.norm0", blk["norm0"])
        out.update(pvcnn2_state_dict(blk["pvcnn"], specs, f"{b}.pvcnn"))
        _norm(out, f"{b}.norm2", blk["norm2"])
        _dense(out, f"{b}.mlp_fc1", blk["mlp_fc1"])
        _dense(out, f"{b}.mlp_fc2", blk["mlp_fc2"])
        i += 1
    _dense(out, f"{pre}.output_projection", p["output_projection"])
    fm = params.get("feature_model", {})
    fm = fm.get("params", fm)
    if "vit" in fm:
        out.update(vit_state_dict(fm["vit"], "feature_model.model"))
    return out


def pvd_state_dict(params: Dict, specs: PVCNN2Specs) -> Dict[str, np.ndarray]:
    """JAX PVD backbone params -> the reference PVD keys (`model.*`)."""
    return pvcnn2_state_dict(params, specs, "model")


def load_into(module: nn.Module, state: Dict[str, np.ndarray]) -> None:
    """Load a converted state_dict, reshaping 1x1 weights to the module's
    (out, in, 1...) shapes; every key must match (strict)."""
    target = module.state_dict()
    missing = set(target) - set(state)
    extra = set(state) - set(target)
    if missing or extra:
        raise KeyError(f"missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    module.load_state_dict({
        k: torch.tensor(np.asarray(v)).reshape(target[k].shape)
        for k, v in state.items()})


def grads_state_dict(grads: Dict, specs: PVCNN2Specs,
                     prefix: str = "point_cloud_model.model"
                     ) -> Dict[str, np.ndarray]:
    """A gradient tree of a PVCNN2 backbone (`jax.grad` gives the
    parameters' structure; a PC2 tree's `point_cloud_model` is taken) ->
    the names of the port's `named_parameters()`, so a test compares
    `jax.grad` with `.grad` name by name. The layout rules are the
    parameters': a gradient transposes as its weight does. `prefix` is
    "point_cloud_model.model" for PC2, "model" for PVD."""
    return pvcnn2_state_dict(grads.get("point_cloud_model", grads), specs,
                             prefix)


def fusion_grads_state_dict(grads: Dict, pc2_specs: PVCNN2Specs,
                            pvd_specs: PVCNN2Specs,
                            prefix: str = "fusion_model.model"
                            ) -> Dict[str, np.ndarray]:
    """As `grads_state_dict`, for a gradient tree of the fusion network
    (or a merging tree, whose `fusion_model` is taken)."""
    return fusion_state_dict(grads.get("fusion_model", grads), pc2_specs,
                             pvd_specs, prefix)
