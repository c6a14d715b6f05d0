"""JAX parameter trees -> the port's state dicts (numpy only), and the two
training conversions.

Counterpart of ``this_and_that_vdm_tpu/weights/export.py``
(``flax_to_torch_state_dict`` for the UNet, ControlNet and VAE,
``clip_flax_to_torch_state_dict`` for the CLIP towers).  The port's modules
carry the HF key names, so the result loads with ``load_state_dict`` and an
HF checkpoint loads with no converter at all.  ``controlnet_from_unet``
seeds a GestureNet from a UNet (``weights/convert.py``
``controlnet_params_from_unet``); ``flax_adam8bit_state_to_torch`` carries a
JAX 8-bit Adam state over.

Kernel transposes by rank: dense (I, O) -> (O, I); conv (H, W, I, O) ->
(O, I, H, W); temporal (3, I, O) -> (O, I, 3, 1, 1); norm ``scale`` ->
``weight``; embeddings keep their orientation.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# flax scopes named ``<list>_<i>`` that fold back into ``<list>.<i>``
_LIST_SCOPES = ("down_blocks", "up_blocks", "resnets", "attentions", "transformer_blocks",
                "temporal_transformer_blocks", "downsamplers", "upsamplers",
                "controlnet_down_blocks", "layers")
_GEGLU_SCOPES = ("ff", "ff_in")
_CLIP_EMBED_SCOPES = ("token_embedding", "position_embedding", "patch_embedding")


def _leaf(name: str, arr: np.ndarray):
    """One flax leaf -> (torch leaf name, array)."""
    if name in ("scale", "embedding"):
        return "weight", arr
    if name == "mix_factor":
        return name, arr.reshape(1)
    if name in ("bias", "class_embedding"):
        return name, arr
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 3:  # temporal (3,1,1) conv stored (3, I, O)
            return "weight", arr.transpose(2, 1, 0)[:, :, :, None, None]
    raise ValueError(f"cannot convert leaf {name} of shape {arr.shape}")


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path, k, np.asarray(v)


def _scope_parts(path):
    parts = []
    for p in path:
        base, _, idx = p.rpartition("_")
        if idx.isdigit() and base in _LIST_SCOPES:
            parts += [base, idx]
        elif p.startswith("mlp_fc"):
            parts += ["mlp", p[len("mlp_"):]]
        else:
            parts.append(p)
    return parts


def _diffusers_leaf(path, name: str, arr: np.ndarray):
    """One UNet / ControlNet / VAE leaf -> (HF key, array in torch layout)."""
    parts = _scope_parts(path)
    if parts and parts[-1] == "to_out":
        parts.append("0")
    if len(parts) >= 2 and parts[-2] in _GEGLU_SCOPES:
        if parts[-1] == "proj":
            parts = parts[:-1] + ["net", "0", "proj"]
        elif parts[-1] == "proj_out":
            parts = parts[:-1] + ["net", "2"]
    leaf, t = _leaf(name, arr)
    return ".".join(parts + [leaf]), t


def _diffusers(tree) -> Dict[str, np.ndarray]:
    return dict(_diffusers_leaf(path, name, arr) for path, name, arr in _walk(tree))


def _clip(tree, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for path, name, arr in _walk(tree):
        leaf, t = _leaf(name, arr)
        parts = _scope_parts(path)
        if not path or path[0] in _CLIP_EMBED_SCOPES:
            parts = ["embeddings"] + parts
        key = ".".join(parts + [leaf])
        out[key if path[:1] == ("visual_projection",) else prefix + key] = t
    return out


def flax_params_to_torch(params: Dict) -> Dict[str, np.ndarray]:
    """A JAX model's parameter tree (``{"params": ...}`` or the bare tree)
    -> the port's state dict with HF keys.  CLIP towers are recognised by
    their embedding scopes (text: ``token_embedding``; vision:
    ``class_embedding``)."""
    tree = params.get("params", params)
    if "token_embedding" in tree:
        return _clip(tree, "text_model.")
    if "class_embedding" in tree:
        return _clip(tree, "vision_model.")
    return _diffusers(tree)


def load_flax_params(module, params: Dict) -> None:
    """Load a JAX parameter tree into a port module (strict: every key must
    match both ways)."""
    import torch

    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in flax_params_to_torch(params).items()}
    module.load_state_dict(state, strict=True)


def controlnet_from_unet(unet, controlnet):
    """Seed a GestureNet from a UNet, in place (counterpart of
    ``controlnet_params_from_unet``; reference ``from_unet``): copy
    ``time_embedding``, ``down_blocks`` and ``mid_block``; keep the
    ControlNet's ``conv_in_concat``, zero convs and ``add_embedding``
    (``from_unet`` does not copy it)."""
    import torch

    src = unet.state_dict()
    with torch.no_grad():
        for name, t in controlnet.state_dict().items():
            if name.split(".")[0] in ("time_embedding", "down_blocks", "mid_block"):
                t.copy_(src[name])
    return controlnet


def flax_adam8bit_state_to_torch(state, params):
    """A JAX ``Adam8bitState`` (``training/optimizers.py``) of a UNet or
    ControlNet -> the port's ``Adam8bitState`` keyed by HF names.

    ``params`` is the JAX parameter tree the state was made for (it gives
    each leaf's shape).  Leaves whose flattening is the same in both layouts
    (1-D and embedding leaves) keep their codes and scales bit for bit.  The
    others are quantised over the other flattening (flax ``(I, O)`` /
    ``(H, W, I, O)`` against torch ``(O, I)`` / ``(O, I, H, W)``): they are
    dequantised in the JAX layout, transposed and quantised again, so they
    lose one quantisation round (the round-trip error of the log codebook,
    under 8% relative on representable magnitudes)."""
    import torch

    from ..training.optimizers import Adam8bitState, Q, _dequantize, _quantize

    mu_tree, nu_tree = (t.get("params", t) for t in (state.mu, state.nu))
    mu, nu = {}, {}
    for path, name, arr in _walk(params.get("params", params)):
        idx = np.arange(arr.size).reshape(arr.shape)
        key, perm = _diffusers_leaf(path, name, idx)
        perm = np.ascontiguousarray(perm).reshape(-1)
        identity = np.array_equal(perm, np.arange(perm.size))
        for out, tree, signed in ((mu, mu_tree, True), (nu, nu_tree, False)):
            qv = tree
            for k in path + (name,):
                qv = qv[k]
            q = Q(torch.from_numpy(np.array(qv.q)), torch.from_numpy(np.array(qv.scale)))
            if identity:
                out[key] = q
            else:
                flat = _dequantize(q, (perm.size,), signed)
                out[key] = _quantize(flat[torch.from_numpy(perm)], signed)
    return Adam8bitState(int(np.asarray(state.count)), mu, nu)
