"""XMem inference: working and long-term memory and the per-frame core
(counterpart of ``curation/xmem_tracker.py``).

Replicates the reference's inference stack (track_anything_code/tracker/
inference/{inference_core,memory_manager,kv_memory_store}.py and
tracker/util/{mask_mapper,tensor_util}.py) on ``models/xmem.XMem``:

  * ``KeyValueMemoryStore``: token-major keys shared by the object groups,
    per-group values, usage counting, range sieving and eviction;
  * ``MemoryManager``: working memory, long-term consolidation into
    usage-ranked prototypes, the GRU hidden state;
  * ``XMemInferenceCore``: the mem_every / deep-update schedule
    (inference_core.py:42-115);
  * ``MaskMapper``, ``pad_divide_by``, ``unpad``, ``all_to_onehot``.

The memory lives on the model's device as tensors.  It evicts exactly as
the JAX store does (every slot tied at the threshold goes, so eviction is
not a top-k), and consolidation ranks prototypes with numpy's ``argsort``
on the host, as JAX does, so tied usages pick the same prototypes.  Usage
reaches the host once per consolidation and never per frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.xmem import (XMem, aggregate, key_similarity, normalize_imagenet, tokens,
                           topk_softmax)

DEFAULT_CONFIG: Dict = {
    # reference track_anything_code/tracker/config/config.yaml
    "top_k": 30,
    "mem_every": 5,
    "deep_update_every": -1,
    "enable_long_term": True,
    "enable_long_term_count_usage": True,
    "max_mid_term_frames": 10,
    "min_mid_term_frames": 5,
    "num_prototypes": 128,
    "max_long_term_elements": 1000,
    "hidden_dim": 64,
}


# ------------------------------------------------------------------ utilities


def pad_divide_by(arr: np.ndarray, d: int) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Centre-pad H and W to multiples of ``d``: axes (0, 1) of an HWC image
    (last axis 1 or 3), else the last two.  Returns (padded, (lw, uw, lh, uh))."""
    if arr.ndim == 3 and arr.shape[-1] in (1, 3):
        h_ax, w_ax = 0, 1
    else:
        h_ax, w_ax = arr.ndim - 2, arr.ndim - 1
    h, w = arr.shape[h_ax], arr.shape[w_ax]
    ph, pw = (-h) % d, (-w) % d
    lh, lw = ph // 2, pw // 2
    pad = [(0, 0)] * arr.ndim
    pad[h_ax], pad[w_ax] = (lh, ph - lh), (lw, pw - lw)
    return np.pad(arr, pad), (lw, pw - lw, lh, ph - lh)


def unpad(arr, pad: Tuple[int, int, int, int], h_ax: int, w_ax: int):
    """Crop what ``pad_divide_by`` added (numpy array or tensor)."""
    lw, uw, lh, uh = pad
    sl = [slice(None)] * arr.ndim
    if lh + uh > 0:
        sl[h_ax] = slice(lh, arr.shape[h_ax] - uh)
    if lw + uw > 0:
        sl[w_ax] = slice(lw, arr.shape[w_ax] - uw)
    return arr[tuple(sl)]


def all_to_onehot(mask: np.ndarray, labels: Sequence[int]) -> np.ndarray:
    """Indexed mask ``[H, W]`` -> one-hot ``[len(labels), H, W]`` uint8."""
    return np.stack([(mask == lab).astype(np.uint8) for lab in labels], 0)


class MaskMapper:
    """Remaps possibly non-contiguous object labels to 1..N and back
    (reference tracker/util/mask_mapper.py)."""

    def __init__(self):
        self.labels: List[int] = []
        self.remappings: Dict[int, int] = {}
        self.coherent = True

    def convert_mask(self, mask: np.ndarray, exhaustive: bool = False):
        labels = [int(lab) for lab in np.unique(mask) if lab != 0]
        new_labels = [lab for lab in labels if lab not in self.labels]
        if not exhaustive and len(new_labels) != len(labels):
            raise ValueError("old labels in non-exhaustive mode")
        for i, lab in enumerate(new_labels):
            self.remappings[lab] = i + len(self.labels) + 1
            if self.coherent and i + len(self.labels) + 1 != lab:
                self.coherent = False
        if exhaustive:
            mapped = list(range(1, len(self.labels) + len(new_labels) + 1))
        elif self.coherent:
            mapped = new_labels
        else:
            mapped = list(range(len(self.labels) + 1, len(self.labels) + len(new_labels) + 1))
        self.labels.extend(new_labels)
        return all_to_onehot(mask, self.labels).astype(np.float32), mapped

    def remap_index_mask(self, mask: np.ndarray) -> np.ndarray:
        if self.coherent:
            return mask
        out = np.zeros_like(mask)
        for lab, i in self.remappings.items():
            out[mask == i] = lab
        return out


def _readout(affinity, mv):
    """affinity ``[1, P, Ng]``, mv ``[num_obj, Ng, CV]`` -> ``[num_obj, P, CV]``."""
    return torch.matmul(affinity, mv)


# ------------------------------------------------------------ key/value store


class KeyValueMemoryStore:
    """Keys ``[1, N, CK]`` shared by the object groups; values a list of
    per-group tensors ``[n_obj_g, N_g, CV]``.  In working memory group ``g``
    owns the last ``N_g`` key slots; long-term groups carry the exact key
    slot of every value column in ``v_idx`` (consolidation's valid
    prototypes follow usage order and are not a suffix)."""

    def __init__(self, count_usage: bool):
        self.count_usage = count_usage
        self.k: Optional[torch.Tensor] = None
        self.s: Optional[torch.Tensor] = None
        self.e: Optional[torch.Tensor] = None
        self.v: List[Optional[torch.Tensor]] = []
        self.v_idx: List[Optional[torch.Tensor]] = []
        self.obj_groups: List[List[int]] = []
        self.all_objects: List[int] = []
        self.use_count: Optional[torch.Tensor] = None
        self.life_count: Optional[torch.Tensor] = None

    def add(self, key, value, shrinkage, selection, objects: Optional[List[int]],
            value_key_idx: Optional[List[Optional[torch.Tensor]]] = None):
        """Working memory (``objects`` given): ``value`` ``[num_obj, n, CV]`` is
        spread over the groups, newcomers opening a group.  Long-term
        (``objects`` None): ``value`` is a per-group list (None skips the
        group this round) and ``value_key_idx[g]`` places each column among
        the ``n`` appended keys."""
        n_new = key.shape[1]
        old_size = self.size
        zeros = key.new_zeros(n_new)
        if self.k is None:
            self.k, self.s, self.e = key, shrinkage, selection
            if self.count_usage:
                self.use_count, self.life_count = zeros, zeros + 1e-7
        else:
            self.k = torch.cat([self.k, key], 1)
            if shrinkage is not None:
                self.s = torch.cat([self.s, shrinkage], 1)
            if selection is not None:
                self.e = torch.cat([self.e, selection], 1)
            if self.count_usage:
                self.use_count = torch.cat([self.use_count, zeros])
                self.life_count = torch.cat([self.life_count, zeros + 1e-7])

        if objects is not None:
            remaining = [obj - 1 for obj in objects]
            for gi, group in enumerate(self.obj_groups):
                for obj in group:
                    remaining.remove(obj)
                self.v[gi] = torch.cat([self.v[gi], value[group]], 1)
            if remaining:
                self.v.append(value[remaining])
                self.obj_groups.append(list(remaining))
                self.all_objects.extend(remaining)
                if sorted(self.all_objects) != self.all_objects:
                    raise ValueError("objects must be inserted in sorted order")
            return
        for gi, gv in enumerate(value):
            if gv is None:
                continue
            if value_key_idx is None or value_key_idx[gi] is None:
                local = torch.arange(gv.shape[1], device=key.device)
            else:
                local = torch.as_tensor(value_key_idx[gi], dtype=torch.long, device=key.device)
            gidx = old_size + local
            while len(self.v) <= gi:
                self.v.append(None)
                self.v_idx.append(None)
            if self.v[gi] is None:
                self.v[gi], self.v_idx[gi] = gv, gidx
            else:
                self.v[gi] = torch.cat([self.v[gi], gv], 1)
                self.v_idx[gi] = torch.cat([self.v_idx[gi], gidx])

    def update_usage(self, usage):
        if not self.count_usage:
            return
        self.use_count = self.use_count + usage.reshape(-1)
        self.life_count = self.life_count + 1.0

    def get_usage(self):
        if not self.count_usage:
            raise RuntimeError("usage was not counted")
        return self.use_count / self.life_count

    def sieve_by_range(self, start: int, end: int, min_size: int):
        """Drop token slots ``[start, end)`` (``end <= 0`` counts from the
        back); values shorter than ``min_size`` are left alone."""
        def cut(a, dim):
            if a is None:
                return None
            n = a.shape[dim]
            stop = n if end == 0 else (n + end if end < 0 else end)
            return torch.cat([a.narrow(dim, 0, start), a.narrow(dim, stop, n - stop)], dim)

        self.k, self.s, self.e = cut(self.k, 1), cut(self.s, 1), cut(self.e, 1)
        if self.count_usage:
            self.use_count, self.life_count = cut(self.use_count, 0), cut(self.life_count, 0)
        for gi in range(self.num_groups):
            if self.v[gi].shape[1] >= min_size:
                self.v[gi] = cut(self.v[gi], 1)

    def remove_obsolete_features(self, max_size: int):
        """Evict the lowest-usage slots down to ``max_size``: every slot at
        or below the ``drop``-th smallest usage goes (ties included, as in
        the JAX store).  Long-term groups remap through ``v_idx`` exactly;
        working groups keep the suffix rule, which is exact there (the
        reference raises for more than one group,
        kv_memory_store.py:146-151)."""
        drop = self.size - max_size
        if drop <= 0:
            return
        old_size = self.size
        usage = self.get_usage()
        threshold = torch.sort(usage).values[drop - 1]
        survived = usage > threshold
        new_pos = torch.cumsum(survived.long(), 0) - 1
        self.k = self.k[:, survived]
        self.s = self.s[:, survived] if self.s is not None else None
        self.e = self.e[:, survived] if self.e is not None else None
        for gi in range(self.num_groups):
            if self.v[gi] is None:
                continue
            if gi < len(self.v_idx) and self.v_idx[gi] is not None:
                keep = survived[self.v_idx[gi]]
                self.v[gi] = self.v[gi][:, keep]
                self.v_idx[gi] = new_pos[self.v_idx[gi][keep]]
            else:
                self.v[gi] = self.v[gi][:, survived[old_size - self.v[gi].shape[1]:]]
        self.use_count = self.use_count[survived]
        self.life_count = self.life_count[survived]

    def get_all_sliced(self, start: int, end: int):
        sl = slice(start, None) if end == 0 else slice(start, end)
        return (self.k[:, sl], self.s[:, sl] if self.s is not None else None,
                self.e[:, sl] if self.e is not None else None, self.get_usage()[sl])

    def get_v_size(self, gi: int) -> int:
        return 0 if self.v[gi] is None else self.v[gi].shape[1]

    def engaged(self) -> bool:
        return self.k is not None

    @property
    def size(self) -> int:
        return 0 if self.k is None else self.k.shape[1]

    @property
    def num_groups(self) -> int:
        return len(self.v)


# ------------------------------------------------------------- memory manager


class MemoryManager:
    """Working and long-term memory with the hidden state (reference
    tracker/inference/memory_manager.py)."""

    def __init__(self, config: Dict = DEFAULT_CONFIG):
        self.hidden_dim = config["hidden_dim"]
        self.top_k = config["top_k"]
        self.enable_long_term = config["enable_long_term"]
        self.enable_long_term_usage = config["enable_long_term_count_usage"]
        if self.enable_long_term:
            self.max_mt_frames = config["max_mid_term_frames"]
            self.min_mt_frames = config["min_mid_term_frames"]
            if self.min_mt_frames < 2:  # the candidate slice [HW:-0] would be empty
                raise ValueError("min_mid_term_frames must be >= 2")
            self.num_prototypes = config["num_prototypes"]
            self.max_long_elements = config["max_long_term_elements"]
        self.HW = None
        self.hidden: Optional[torch.Tensor] = None  # [1, n, Ch, h, w]
        self.work_mem = KeyValueMemoryStore(count_usage=self.enable_long_term)
        if self.enable_long_term:
            self.long_mem = KeyValueMemoryStore(count_usage=self.enable_long_term_usage)

    def _long_group_engaged(self, gi: int, use_long: bool) -> bool:
        return use_long and gi < self.long_mem.num_groups and self.long_mem.v[gi] is not None

    def match_memory(self, query_key, selection):
        """query_key / selection ``[1, CK, h, w]`` -> readout
        ``[1, num_obj, CV, h, w]``."""
        h, w = query_key.shape[-2:]
        qk = tokens(query_key)
        qe = tokens(selection) if selection is not None else None
        use_long = self.enable_long_term and self.long_mem.engaged()
        long_size = self.long_mem.size if use_long else 0
        if use_long:
            mk = torch.cat([self.long_mem.k, self.work_mem.k], 1)
            ms = torch.cat([self.long_mem.s, self.work_mem.s], 1)
        else:
            mk, ms = self.work_mem.k, self.work_mem.s
        sim = key_similarity(mk, ms, qk, qe)  # [1, P, N]
        work_sim, long_sim = sim[:, :, long_size:], sim[:, :, :long_size]

        def group_sim(gi, work_part):
            if self._long_group_engaged(gi, use_long):
                return torch.cat([long_sim[:, :, self.long_mem.v_idx[gi]], work_part], -1)
            return work_part

        # group 0 owns every working slot; its affinity also gives the usage
        aff0, usage = topk_softmax(group_sim(0, work_sim), self.top_k, return_usage=True)
        affinities = [aff0]
        for gi in range(1, self.work_mem.num_groups):
            part = work_sim[:, :, work_sim.shape[-1] - self.work_mem.get_v_size(gi):]
            affinities.append(topk_softmax(group_sim(gi, part), self.top_k))

        if use_long:
            values = [torch.cat([self.long_mem.v[gi], self.work_mem.v[gi]], 1)
                      if self._long_group_engaged(gi, use_long) else self.work_mem.v[gi]
                      for gi in range(self.work_mem.num_groups)]
            self.work_mem.update_usage(usage[0, usage.shape[1] - self.work_mem.size:])
            if self.enable_long_term_usage:
                long_usage = usage.new_zeros(long_size)
                if self._long_group_engaged(0, use_long):
                    idx0 = self.long_mem.v_idx[0]
                    long_usage[idx0] = usage[0, :idx0.numel()]
                self.long_mem.update_usage(long_usage)
        else:
            values = self.work_mem.v
            if self.enable_long_term:
                self.work_mem.update_usage(usage[0])

        out = torch.cat([_readout(a, v) for a, v in zip(affinities, values)], 0)
        return out.transpose(1, 2).reshape(1, out.shape[0], -1, h, w)

    def add_memory(self, key, shrinkage, value, objects: List[int], selection=None):
        """key / selection ``[1, CK, h, w]``, shrinkage ``[1, 1, h, w]``, value
        ``[1, num_obj, CV, h, w]``."""
        if self.HW is None:
            self.HW = key.shape[-2] * key.shape[-1]
            if self.enable_long_term:
                self.min_work_elements = self.min_mt_frames * self.HW
                self.max_work_elements = self.max_mt_frames * self.HW
        self.work_mem.add(tokens(key), tokens(value[0]), shrinkage.reshape(1, -1),
                          tokens(selection) if selection is not None else None, objects)
        if self.enable_long_term and self.work_mem.size >= self.max_work_elements:
            if self.long_mem.size >= self.max_long_elements - self.num_prototypes:
                self.long_mem.remove_obsolete_features(
                    self.max_long_elements - self.num_prototypes)
            self.compress_features()

    def compress_features(self):
        hw, total = self.HW, self.work_mem.size
        end = -self.min_work_elements + hw
        candidate_value = [gv[:, hw:end] if (gv.shape[1] == total
                                             or gv.shape[1] > self.min_work_elements + hw)
                           else None for gv in self.work_mem.v]
        pk, pv, ps, pidx = self.consolidation(*self.work_mem.get_all_sliced(hw, end),
                                              candidate_value)
        self.work_mem.sieve_by_range(hw, end, min_size=self.min_work_elements + hw)
        self.long_mem.add(pk, pv, ps, selection=None, objects=None, value_key_idx=pidx)

    def consolidation(self, cand_key, cand_shrinkage, cand_selection, usage, candidate_value):
        """Distil candidates into usage-ranked prototypes
        (memory_manager.py:245-285).  cand_key ``[1, N, CK]``, usage ``[N]``."""
        n = cand_key.shape[1]
        k = min(self.num_prototypes, n)
        order = np.argsort(-usage.cpu().numpy())[:k]  # numpy's order among ties, as in JAX
        proto_idx = torch.from_numpy(order).to(cand_key.device)
        proto_key = cand_key[:, proto_idx]
        proto_sel = cand_selection[:, proto_idx] if cand_selection is not None else None
        # candidates attend onto the prototypes: [1, P=proto, N=cand]
        sim = key_similarity(cand_key, cand_shrinkage, proto_key, proto_sel)

        proto_value, proto_value_idx, affinity0 = [], [], None
        for gi, gv in enumerate(candidate_value):
            valid = None if gv is None else order >= n - gv.shape[1]
            if gv is None or not valid.any():
                proto_value.append(None)
                proto_value_idx.append(None)
                continue
            vi = torch.from_numpy(np.nonzero(valid)[0]).to(cand_key.device)
            aff = topk_softmax(sim[:, vi][:, :, n - gv.shape[1]:], None)
            if gi == 0:
                affinity0 = aff
            proto_value.append(_readout(aff, gv))
            proto_value_idx.append(vi)
        proto_shrinkage = (torch.einsum("xpn,xn->xp", affinity0, cand_shrinkage)
                           if affinity0 is not None and cand_shrinkage is not None else None)
        return proto_key, proto_value, proto_shrinkage, proto_value_idx

    # hidden state
    def create_hidden_state(self, n: int, sample_key):
        h, w = sample_key.shape[-2:]
        if self.hidden is None:
            self.hidden = sample_key.new_zeros(1, n, self.hidden_dim, h, w)
        elif self.hidden.shape[1] != n:
            extra = sample_key.new_zeros(1, n - self.hidden.shape[1], self.hidden_dim, h, w)
            self.hidden = torch.cat([self.hidden, extra], 1)

    def set_hidden(self, hidden):
        self.hidden = hidden

    def get_hidden(self):
        return self.hidden


# -------------------------------------------------------------- inference core


class XMemInferenceCore:
    """Per frame: encode the key, read the memory, segment, and write the
    memory every ``mem_every`` frames with synchronised deep hidden updates
    (reference inference_core.py)."""

    def __init__(self, model: XMem, config: Dict = DEFAULT_CONFIG):
        self.model = model
        self.device = next(model.parameters()).device
        self.config = dict(config)
        self.mem_every = self.config["mem_every"]
        self.deep_update_every = self.config["deep_update_every"]
        self.enable_long_term = self.config["enable_long_term"]
        self.deep_update_sync = self.deep_update_every < 0
        self.clear_memory()
        self.all_labels: Optional[List[int]] = None

    def clear_memory(self):
        self.curr_ti = -1
        self.last_mem_ti = 0
        if not self.deep_update_sync:
            self.last_deep_update_ti = -self.deep_update_every
        self.memory = MemoryManager(self.config)

    def set_all_labels(self, all_labels: List[int]):
        self.all_labels = list(all_labels)

    @torch.no_grad()
    def step(self, image01: np.ndarray, mask: Optional[np.ndarray] = None,
             valid_labels: Optional[List[int]] = None, end: bool = False) -> torch.Tensor:
        """image01 ``[H, W, 3]`` float32 RGB in [0, 1]; mask ``[num_obj, H, W]``
        one-hot (no background) on frames that bring objects.  Returns the
        probabilities with background ``[num_obj + 1, H, W]`` on the device."""
        self.curr_ti += 1
        frame = torch.from_numpy(np.ascontiguousarray(image01, np.float32))
        frame, self.pad = pad_divide_by(normalize_imagenet(frame).numpy(), 16)
        frame = torch.from_numpy(frame).to(self.device).permute(2, 0, 1)[None]

        is_mem_frame = ((self.curr_ti - self.last_mem_ti >= self.mem_every)
                        or (mask is not None)) and not end
        need_segment = self.curr_ti > 0 and (
            valid_labels is None or len(self.all_labels) != len(valid_labels))
        is_deep_update = ((self.deep_update_sync and is_mem_frame) or (
            not self.deep_update_sync
            and self.curr_ti - self.last_deep_update_ti >= self.deep_update_every)) and not end
        is_normal_update = (not self.deep_update_sync or not is_deep_update) and not end

        key, shrinkage, selection, f16, f8, f4 = self.model.encode_key(
            frame, is_mem_frame, self.enable_long_term or need_segment)

        prob = None
        if need_segment:
            readout = self.memory.match_memory(key, selection)
            hidden, _logits, prob = self.model.segment(f16, f8, f4, readout,
                                                       self.memory.get_hidden(),
                                                       is_normal_update, False)
            prob = prob[0]
            if is_normal_update:
                self.memory.set_hidden(hidden)

        if mask is not None:
            mask = torch.from_numpy(pad_divide_by(mask.astype(np.float32), 16)[0]).to(self.device)
            if prob is not None:
                pred_no_bg = prob[1:].masked_fill(mask.sum(0) > 0.5, 0.0)
                if valid_labels is not None:
                    for i in range(pred_no_bg.shape[0]):
                        if (i + 1) not in valid_labels:
                            mask[i] = pred_no_bg[i]
            prob = aggregate(mask, 0)
            self.memory.create_hidden_state(len(self.all_labels), key)

        if is_mem_frame:
            value, hidden = self.model.encode_value(frame, f16, self.memory.get_hidden(),
                                                    prob[1:][None], is_deep_update)
            self.memory.add_memory(key, shrinkage, value, self.all_labels,
                                   selection=selection if self.enable_long_term else None)
            self.last_mem_ti = self.curr_ti
            if is_deep_update:
                self.memory.set_hidden(hidden)
                self.last_deep_update_ti = self.curr_ti
        return unpad(prob, self.pad, 1, 2)


def xmem_propagator(model: XMem, config: Dict = DEFAULT_CONFIG):
    """The tracking facade's propagator: ``(frames_rgb uint8 list, first_mask
    bool [H, W]) -> list of bool masks``, the first mask carried through the
    clip by XMem on the model's device."""
    core = XMemInferenceCore(model, config)

    def propagate(frames_rgb: Sequence[np.ndarray], first_mask: np.ndarray):
        core.clear_memory()
        core.set_all_labels([1])
        masks = []
        for ti, frame in enumerate(frames_rgb):
            img = frame.astype(np.float32) / 255.0
            if ti == 0:
                core.step(img, mask=first_mask[None].astype(np.float32))
                masks.append(first_mask.astype(bool))
            else:
                prob = core.step(img)
                masks.append((prob[1:].sum(0) > 0.5).cpu().numpy())
        return masks

    return propagate
