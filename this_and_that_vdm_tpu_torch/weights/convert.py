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

import re
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


# ------------------------------------------------- perception models (curation)

def _unfold_ints(seg: str) -> str:
    """A flax scope with folded list indices back to dotted form:
    ``cv2_0_1`` -> ``cv2.0.1``, ``blocks_3`` -> ``blocks.3``."""
    parts = []
    base, _, idx = seg.rpartition("_")
    while base and idx.isdigit():
        parts.insert(0, idx)
        seg = base
        base, _, idx = seg.rpartition("_")
    return ".".join([seg] + parts)


_BN_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _perception_leaf(path, name: str, arr: np.ndarray):
    """(dotted module path, torch leaf, array) of one leaf of a JAX
    perception model; ``FrozenBatchNorm``'s ``mean``/``var`` become the
    running statistics."""
    if name in _BN_LEAVES:
        return ".".join(_unfold_ints(p) for p in path), _BN_LEAVES[name], arr
    leaf, t = _leaf(name, arr)
    return ".".join(_unfold_ints(p) for p in path), leaf, t


def _with_bn_counters(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Add ``num_batches_tracked`` (0) beside every batch norm's statistics,
    as ``nn.BatchNorm2d``'s state dict holds it."""
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = np.array(0, np.int64)
    return sd


def flax_yolo_params_to_torch(params: Dict) -> Dict[str, np.ndarray]:
    """JAX YOLOv8 parameters -> the ultralytics ``DetectionModel`` state
    dict that ``models/yolov8.YOLOv8`` loads (inverse of the JAX
    ``yolo_state_dict_to_flax``; the fixed ``arange`` DFL weight, which the
    JAX model computes in closed form, is put back)."""
    sd = {}
    for path, name, arr in _walk(params.get("params", params)):
        mod, leaf, t = _perception_leaf(path, name, arr)
        sd[f"{mod}.{leaf}"] = t
    reg_max = sd["model.22.cv2.0.2.weight"].shape[0] // 4
    sd["model.22.dfl.conv.weight"] = np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1)
    return _with_bn_counters(sd)


def flax_raft_params_to_torch(params: Dict) -> Dict[str, np.ndarray]:
    """JAX RAFT parameters -> the princeton-vl RAFT state dict (no
    ``module.`` prefix) that ``models/raft.RAFT`` loads (inverse of the JAX
    ``raft_state_dict_to_flax``).  The official residual block registers its
    shortcut norm twice, so each ``downsample.1`` batch norm also appears as
    ``norm3``."""
    sd = {}
    for path, name, arr in _walk(params.get("params", params)):
        mod, leaf, t = _perception_leaf(path, name, arr)
        sd[f"{mod.replace('flow_head_', 'flow_head.')}.{leaf}"] = t
    for k in [k for k in sd if ".downsample.1." in k]:
        sd[k.replace(".downsample.1.", ".norm3.")] = sd[k]
    return _with_bn_counters(sd)


_SAM_SEQ = {"neck_conv1": "neck.0", "neck_ln1": "neck.1", "neck_conv2": "neck.2",
            "neck_ln2": "neck.3", "mask_conv1": "mask_downscaling.0",
            "mask_ln1": "mask_downscaling.1", "mask_conv2": "mask_downscaling.3",
            "mask_ln2": "mask_downscaling.4", "mask_conv3": "mask_downscaling.6",
            "upscale_conv1": "output_upscaling.0", "upscale_ln": "output_upscaling.1",
            "upscale_conv2": "output_upscaling.3", "patch_embed": "patch_embed.proj"}
_SAM_RENAMES = {"hyper_mlps": "output_hypernetworks_mlps", "iou_head": "iou_prediction_head"}
_SAM_EMBEDS = {"point_embed_neg": "point_embeddings.0", "point_embed_pos": "point_embeddings.1",
               "box_embed_1": "point_embeddings.2", "box_embed_2": "point_embeddings.3",
               "not_a_point": "not_a_point_embed", "no_mask": "no_mask_embed"}


def flax_sam_params_to_torch(params: Dict) -> Dict[str, np.ndarray]:
    """JAX SAM parameters -> the ``sam_vit_*.pth`` state dict that
    ``models/sam.Sam`` loads (inverse of the JAX ``sam_state_dict_to_flax``):
    the flat prompt embeddings go back to ``(1, C)`` embedding tables, the
    einsum kernels of the mask upscaler to ``ConvTranspose2d``'s
    ``(Cin, Cout, 2, 2)``, the named sequence members to their indices."""
    sd = {}
    for path, name, arr in _walk(params.get("params", params)):
        if name in _SAM_EMBEDS:
            sd[f"{path[0]}.{_SAM_EMBEDS[name]}.weight"] = arr.reshape(1, -1)
            continue
        if name in ("iou_token", "mask_tokens"):
            sd[f"{path[0]}.{name}.weight"] = arr
            continue
        if name == "gaussian":
            sd[".".join(path) + ".positional_encoding_gaussian_matrix"] = arr
            continue
        segs = [_SAM_SEQ.get(p, p) for p in path]
        for i, p in enumerate(segs):
            base, _, idx = p.rpartition("_")
            if base in _SAM_RENAMES and idx.isdigit():
                segs[i] = f"{_SAM_RENAMES[base]}_{idx}"
            elif p in _SAM_RENAMES:
                segs[i] = _SAM_RENAMES[p]
        if name in ("rel_pos_h", "rel_pos_w", "pos_embed"):
            leaf, t = name, arr
        elif name == "kernel" and path[-1].startswith("upscale_conv"):
            leaf, t = "weight", arr.transpose(2, 3, 0, 1)
        else:
            leaf, t = _leaf(name, arr)
        sd[".".join(_unfold_ints(p) for p in segs) + "." + leaf] = t
    return sd


_XMEM_DIGIT_SCOPES = ("up_16_8", "up_8_4")  # digits that are not list indices


def flax_xmem_params_to_torch(params: Dict) -> Dict[str, np.ndarray]:
    """JAX XMem parameters -> the ``XMem-s012.pth`` state dict that
    ``models/xmem.XMem`` loads (inverse of the JAX ``xmem_state_dict_to_flax``):
    ``spatial_conv`` back to CBAM's ``spatial.conv``, the batch norms'
    ``mean`` / ``var`` to their running statistics with a
    ``num_batches_tracked`` beside them."""
    sd = {}
    for path, name, arr in _walk(params.get("params", params)):
        segs = [p if p in _XMEM_DIGIT_SCOPES else _unfold_ints(p) for p in path]
        mod, leaf, t = _perception_leaf((), name, arr)
        sd[".".join(segs).replace("spatial_conv", "spatial.conv") + "." + leaf] = t
    return _with_bn_counters(sd)


# ------------------------------------------------ FlowFormer's .npz archives
#
# The JAX ``flowformer_params_save`` writes one array per parameter under its
# ``jax.tree_util.keystr`` path (``['params']['fnet']['patch_embed0']['kernel']``)
# and the config as a JSON blob under ``__config__``.  The port's FlowFormer
# names its modules as the flax ones, so a path maps onto a state-dict key
# by joining its scopes with dots.

_KEYSTR_PART = re.compile(r"\['([^']*)'\]")


def read_flowformer_npz(path: str):
    """(flax parameter tree, config dict or None) of a FlowFormer archive;
    the keystr paths are parsed here (no JAX)."""
    import json

    params, cfg = {}, None
    with np.load(path) as z:
        for key in z.files:
            if key == "__config__":
                cfg = json.loads(bytes(z[key]).decode("utf-8"))
                continue
            parts = _KEYSTR_PART.findall(key)
            if "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"{path}: {key!r} is not a keystr path of a parameter")
            node = params
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return params, cfg


def write_flowformer_npz(path: str, params: Dict, cfg: Dict = None) -> None:
    """Writes a flax parameter tree (and the config dict) as
    ``flowformer_params_save`` does; the JAX ``flowformer_params_load`` reads
    the result."""
    import json

    arrays = {"".join(f"['{p}']" for p in path + (name,)): np.asarray(arr)
              for path, name, arr in _walk(params)}
    if cfg is not None:
        arrays["__config__"] = np.frombuffer(json.dumps(cfg).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:  # a file object: np.savez adds no ".npz" to it
        np.savez(f, **arrays)


def flax_flowformer_params_to_torch(params: Dict) -> Dict[str, np.ndarray]:
    """JAX FlowFormer parameters -> the state dict of ``models/flowformer.
    FlowFormer``: dense (I, O) and conv (H, W, I, O) kernels transposed,
    LayerNorm ``scale`` -> ``weight``; ``latents`` and GMA's ``gamma`` as
    they are."""
    sd = {}
    for path, name, arr in _walk(params.get("params", params)):
        leaf, t = (name, arr) if name in ("latents", "gamma") else _leaf(name, arr)
        sd[".".join(path + (leaf,))] = np.array(t, order="C")
    return sd


def torch_flowformer_state_dict_to_flax(sd: Dict[str, np.ndarray]) -> Dict:
    """The inverse of ``flax_flowformer_params_to_torch``: ``{"params": ...}``
    with flax names and layouts (a 1-D ``weight`` is a LayerNorm scale)."""
    params: Dict = {}
    for key, value in sd.items():
        arr = np.asarray(value)
        *path, leaf = key.split(".")
        if leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            leaf, arr = "kernel", arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(arr, order="C")
    return {"params": params}


# the globals an ultralytics checkpoint needs besides its own classes and
# torch's modules: tensor rebuilds, containers, and the numpy numbers of its
# training metadata
_ULTRALYTICS_GLOBALS = {
    ("torch._tensor", "_rebuild_from_type_v2"), ("torch.nn.parameter", "Parameter"),
    ("torch", "Tensor"), ("torch", "Size"),
    ("collections", "OrderedDict"), ("builtins", "set"), ("builtins", "frozenset"),
    ("_codecs", "encode"),  # bytes in a protocol-2 pickle
    ("numpy", "dtype"), ("numpy", "ndarray"), ("numpy.core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
}


def load_ultralytics_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The flat numpy state dict of an ultralytics ``.pt`` checkpoint,
    without the ultralytics package.

    Ultralytics pickles the whole ``DetectionModel`` module, so a plain
    ``torch.load`` needs its classes.  The unpickler here resolves every
    ``ultralytics.*`` and ``torch.nn.modules.*`` class to an empty shell
    that keeps the instance ``__dict__``, and lets through only torch's
    tensor rebuilds and the plain containers and numpy numbers of the
    training metadata; any other global raises, so a crafted file cannot
    call code.  The module tree is walked through ``_parameters`` /
    ``_buffers`` / ``_modules`` for the dotted names; floating leaves (fp16
    in ultralytics files) are upcast to fp32, integer buffers keep their
    type.  The ``ema`` model is taken when present, as ultralytics'
    ``attempt_load_one_weight`` does."""
    import pickle
    import types

    import torch

    class _Shell:
        def __init__(self, *args, **kwargs):
            pass

        def __setstate__(self, state):
            for part in (state if isinstance(state, tuple) else (state,)):
                if isinstance(part, dict):
                    self.__dict__.update(part)

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            module = "builtins" if module == "__builtin__" else module  # protocol 2
            if module.split(".")[0] == "ultralytics" or module.startswith("torch.nn.modules."):
                return type(name, (_Shell,), {})
            if ((module, name) in _ULTRALYTICS_GLOBALS
                    or (module == "torch._utils" and name.startswith("_rebuild_"))
                    or (module == "torch" and (name.endswith("Storage") or isinstance(
                        getattr(torch, name, None), torch.dtype)))):
                return super().find_class(module, name)
            raise pickle.UnpicklingError(f"{path}: {module}.{name} is not part of an "
                                         "ultralytics checkpoint; refusing to load it")

    shim = types.ModuleType("ultralytics_shim")
    shim.Unpickler = _Unpickler
    shim.load = lambda f, **kw: _Unpickler(f, **kw).load()
    ckpt = torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False)
    model = ckpt.get("ema") or ckpt["model"]

    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        d = getattr(node, "__dict__", {})
        for table in ("_parameters", "_buffers"):
            for k, v in (d.get(table) or {}).items():
                if v is not None:
                    v = v.detach()
                    out[prefix + k] = (v.float() if v.is_floating_point() else v).numpy()
        for k, v in (d.get("_modules") or {}).items():
            if v is not None:
                walk(v, f"{prefix}{k}.")

    walk(model, "")
    return out


def save_ultralytics_checkpoint(path: str, **entries) -> None:
    """Writes ``entries`` (``model=``, ``ema=``, metadata) as ultralytics
    saves a checkpoint: modules pickled whole in fp16, each of the port's
    classes under the ``ultralytics.nn.modules`` path (torch's own keep
    theirs).  For checks that have no published file:
    ``load_ultralytics_state_dict`` reads the result as it reads one."""
    import copy
    import sys
    import types

    import torch

    fake = types.ModuleType("ultralytics.nn.modules")
    own = __name__.split(".")[0]

    def relabel(obj):
        cls = type(obj)
        if cls.__module__.split(".")[0] != own:
            return
        if not hasattr(fake, cls.__name__):
            setattr(fake, cls.__name__, type(cls.__name__, (cls,), {"__module__": fake.__name__}))
        object.__setattr__(obj, "__class__", getattr(fake, cls.__name__))

    out = {}
    for key, value in entries.items():
        if isinstance(value, torch.nn.Module):
            value = copy.deepcopy(value).half().cpu()
            for m in value.modules():
                relabel(m)
                for v in vars(m).values():
                    relabel(v)
        out[key] = value
    mods = {"ultralytics": types.ModuleType("ultralytics"),
            "ultralytics.nn": types.ModuleType("ultralytics.nn"), fake.__name__: fake}
    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        torch.save(out, path)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
