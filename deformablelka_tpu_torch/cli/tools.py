"""Checkpoint / plans surgery utilities.

The port's copy of `deformablelka_tpu/cli/tools.py` (torch and pickle
only); a pickled plans file is read with `data/plans.load_plans`.

    python -m deformablelka_tpu_torch.cli.tools
        rename_keys|change_plans|copy_decoder_weights|summarize_plans|
        change_batch_size ...

Upstream's behaviour, as the JAX package re-derived it:
  3D/rename_layers.py:12-23 — bulk-rename state_dict keys
    (unetr_pp → d_lka_former) in a torch checkpoint.
  3D/change_plans.py — edit a field in a plans pickle.
  2D/copy_model_weights.py — duplicate decoder LKA layer
    weights under a second layer name (used when widening the decoder).
"""

from __future__ import annotations

import argparse
import json


def rename_keys(argv=None):
    """Rename key prefixes in a torch checkpoint (rename_layers.py)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--old", default="unetr_pp")
    ap.add_argument("--new", default="d_lka_former")
    args = ap.parse_args(argv)
    import torch
    obj = torch.load(args.input, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    renamed = {k.replace(args.old, args.new): v for k, v in sd.items()}
    if isinstance(obj, dict) and "state_dict" in obj:
        obj["state_dict"] = renamed
    else:
        obj = renamed
    torch.save(obj, args.output)
    print(f"renamed {sum(args.old in k for k in sd)} keys -> {args.output}")


def change_plans(argv=None):
    """Edit one field in a plans file (change_plans.py). Works on this
    package's JSON plans and on pickled upstream plans."""
    ap = argparse.ArgumentParser()
    ap.add_argument("plans_file")
    ap.add_argument("key", help="dot-path, e.g. plans_per_stage.0.batch_size")
    ap.add_argument("value", help="JSON-parsed value")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    value = json.loads(args.value)
    plans, _ = _load_plans(args.plans_file)
    node = plans
    parts = args.key.split(".")
    for p in parts[:-1]:
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value
    out = args.output or args.plans_file
    if out.endswith(".json"):
        open(out, "w").write(json.dumps(plans, indent=2, default=str))
    else:
        import pickle
        pickle.dump(plans, open(out, "wb"))
    print(f"set {args.key} = {value} -> {out}")


def copy_decoder_weights(argv=None):
    """Duplicate decoder layer weights under a new layer name
    (copy_model_weights.py)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--src", default="layer_lka_1")
    ap.add_argument("--dst", default="layer_lka_2")
    args = ap.parse_args(argv)
    import torch
    obj = torch.load(args.input, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    added = {}
    for k, v in sd.items():
        if args.src in k:
            nk = k.replace(args.src, args.dst)
            if nk not in sd:
                added[nk] = v.clone() if hasattr(v, "clone") else v
    sd.update(added)
    torch.save(obj if isinstance(obj, dict) and "state_dict" in obj
               else sd, args.output)
    print(f"copied {len(added)} tensors {args.src} -> {args.dst}")


def _load_plans(path: str):
    from deformablelka_tpu_torch.data.plans import load_plans
    if str(path).endswith(".json"):
        with open(path) as f:
            return json.load(f), "json"
    return load_plans(path), "pkl"


def summarize_plans(argv=None):
    """Print the key facts of a plans file
    (experiment_planning/summarize_plans.py): spacing, patch, batch,
    pools, normalization, classes — per stage."""
    ap = argparse.ArgumentParser()
    ap.add_argument("plans", help="plans .pkl (reference or ours) or .json")
    args = ap.parse_args(argv)
    plans, _ = _load_plans(args.plans)
    print(f"num_classes: {plans.get('num_classes')}")
    print(f"modalities: {plans.get('num_modalities')}")
    print(f"normalization: {plans.get('normalization_schemes')}")
    print(f"transpose_forward: {plans.get('transpose_forward')}")
    for sid, st in sorted(plans.get("plans_per_stage", {}).items()):
        print(f"stage {sid}:")
        for k in ("batch_size", "patch_size", "current_spacing",
                  "original_spacing", "pool_op_kernel_sizes",
                  "conv_kernel_sizes"):
            if k in st:
                print(f"  {k}: {st[k]}")


def change_batch_size(argv=None):
    """Set batch_size in every stage of a plans file
    (experiment_planning/change_batch_size.py)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("batch_size", type=int)
    ap.add_argument("-o", "--output", default=None,
                    help="default: edit in place")
    args = ap.parse_args(argv)
    plans, kind = _load_plans(args.input)
    for st in plans.get("plans_per_stage", {}).values():
        st["batch_size"] = args.batch_size
    out = args.output or args.input
    if kind == "json":
        with open(out, "w") as f:
            json.dump(plans, f, indent=2)
    else:
        import pickle
        with open(out, "wb") as f:
            pickle.dump(plans, f)
    print(f"batch_size -> {args.batch_size} in {out}")


if __name__ == "__main__":
    import sys
    cmd = sys.argv[1] if len(sys.argv) > 1 else ""
    fns = {"rename_keys": rename_keys, "change_plans": change_plans,
           "copy_decoder_weights": copy_decoder_weights,
           "summarize_plans": summarize_plans,
           "change_batch_size": change_batch_size}
    if cmd in fns:
        fns[cmd](sys.argv[2:])
    else:
        print(f"usage: tools.py [{'|'.join(fns)}] ...")
