"""Raw Bridge -> flat instance folders (``NNNNNN/im_*.jpg`` + ``policy_out.pkl``
+ ``lang.txt``): the port's copy of
``this_and_that_vdm_tpu/curation/prepare_bridge.py`` (reference
curation_pipeline/prepare_bridge_v{1,2}.py, prepare_bridge_csv.py,
prepare_bridge_jsonl.py), standard library only.

Walk the raw tree down to ``raw/traj_group0/traj*/``, keep only trajectories
that carry ``policy_out.pkl``, ``lang.txt`` and the camera folder, copy
``images0`` to ``<dst>/<index>/`` and the aux files alongside.  v1 nests
one directory level less than v2.  ``--export csv`` indexes a flat tree as
an Open-SORA CSV, ``--export jsonl`` a raw tree as a JSONL of paths.

    python -m this_and_that_vdm_tpu_torch.curation.prepare_bridge \\
        --dataset_path RAW --destination_path FLAT [--version 1|2]
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator


def _iter_traj_dirs(dataset_path: str, version: int) -> Iterator[str]:
    # levels above the time-clock dir: v2 = scene/task/order, v1 one less
    depth = 3 if version == 1 else 4
    stack = [(dataset_path, 0)]
    while stack:
        path, d = stack.pop()
        if d < depth:
            if os.path.isdir(path):
                for name in sorted(os.listdir(path)):
                    stack.append((os.path.join(path, name), d + 1))
            continue
        # time-clock level
        if os.path.basename(path) == "lmdb" or not os.path.isdir(path):
            continue
        group = os.path.join(path, "raw", "traj_group0")
        if not os.path.isdir(group):
            continue
        for traj in sorted(os.listdir(group)):
            traj_path = os.path.join(group, traj)
            if os.path.isdir(traj_path):
                yield traj_path


def _valid_traj(traj_path: str, camera: str = "images0") -> bool:
    """Single validity predicate shared by the flattener and the JSONL
    exporter so both enumerate the same instance set."""
    return (os.path.exists(os.path.join(traj_path, "policy_out.pkl"))
            and os.path.exists(os.path.join(traj_path, "lang.txt"))
            and os.path.isdir(os.path.join(traj_path, camera)))


def flatten_bridge(dataset_path: str, destination_path: str, version: int = 2,
                   camera: str = "images0") -> int:
    """Returns the number of flattened instances."""
    if os.path.exists(destination_path):
        shutil.rmtree(destination_path)
    os.makedirs(destination_path)
    idx = 0
    for traj_path in _iter_traj_dirs(dataset_path, version):
        policy = os.path.join(traj_path, "policy_out.pkl")
        lang = os.path.join(traj_path, "lang.txt")
        images = os.path.join(traj_path, camera)
        if not _valid_traj(traj_path, camera):
            continue
        target = os.path.join(destination_path, str(idx))
        if os.path.exists(target):
            shutil.rmtree(target)
        shutil.copytree(images, target)
        shutil.copy(policy, os.path.join(target, "policy_out.pkl"))
        shutil.copy(lang, os.path.join(target, "lang.txt"))
        idx += 1
    return idx


def export_csv(flat_dataset_paths, csv_path: str,
               height: int = 480, width: int = 640) -> int:
    """Flat instance folders -> Open-SORA-style CSV index.

    Replicates reference curation_pipeline/prepare_bridge_csv.py: one row
    per instance ``[path, text, num_frames, height, width]`` where
    num_frames counts the *sequential* ``im_<i>.jpg`` prefix (a gap ends
    the count, prepare_bridge_csv.py:23-27) and text is the first line of
    ``lang.txt``.  Returns the number of data rows written.
    """
    import csv

    rows = [["path", "text", "num_frames", "height", "width"]]
    for root in flat_dataset_paths:
        for name in sorted(os.listdir(root)):
            sub = os.path.join(root, name)
            if not os.path.isdir(sub):
                continue
            lang = os.path.join(sub, "lang.txt")
            if not os.path.exists(lang):
                continue
            n = 0
            while os.path.exists(os.path.join(sub, f"im_{n}.jpg")):
                n += 1
            with open(lang) as f:
                prompt = f.readline()
            rows.append([sub, prompt, n, height, width])
    with open(csv_path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return len(rows) - 1


def export_jsonl(raw_dataset_paths, jsonl_path: str, versions=None,
                 camera: str = "images0") -> int:
    """Raw Bridge roots -> JSONL of valid trajectory paths (one
    ``{"file_path": ...}`` object per line), replicating reference
    curation_pipeline/prepare_bridge_jsonl.py (which calls the flatteners
    with copyfile=False to only enumerate).  Uses the flattener's exact
    validity predicate (incl. the camera images dir) so the index never
    lists a trajectory flattening would reject.  Returns the line count."""
    import json

    versions = versions or [2] * len(raw_dataset_paths)
    count = 0
    with open(jsonl_path, "w") as out:
        for root, version in zip(raw_dataset_paths, versions):
            for traj_path in _iter_traj_dirs(root, version):
                if not _valid_traj(traj_path, camera):
                    continue
                json.dump({"file_path": traj_path}, out)
                out.write("\n")
                count += 1
    return count


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--destination_path", required=True)
    p.add_argument("--version", type=int, choices=[1, 2], default=2)
    p.add_argument("--export", choices=["", "csv", "jsonl"], default="",
                   help="instead of flattening: write an Open-SORA CSV "
                        "(over a flat root) or a JSONL path index (over a "
                        "raw root) to --destination_path")
    args = p.parse_args(argv)
    if args.export == "csv":
        n = export_csv([args.dataset_path], args.destination_path)
        print(f"indexed {n} instances")
    elif args.export == "jsonl":
        n = export_jsonl([args.dataset_path], args.destination_path,
                         [args.version])
        print(f"indexed {n} trajectories")
    else:
        n = flatten_bridge(args.dataset_path, args.destination_path, args.version)
        print(f"flattened {n} instances")


if __name__ == "__main__":
    main()
