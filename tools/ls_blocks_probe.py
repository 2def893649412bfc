"""Time chip_smoke's ``_ls_rank_blocks`` (each rank's blocks of a
params-shaped tree on the card, packed and copied into one shared-memory
segment a rank) against the per-leaf form it replaced (a shared-memory
tensor and a pageable copy a leaf), on the same bf16 tree of
llama3.2-1b's (or another arch's) shapes, in alternating rounds (ABBA),
with the new form's seconds by part.

    PYTHONPATH=src python3 tools/ls_blocks_probe.py [--arch llama3.2-1b]
        [--rounds 2]

Run on a machine with a card; prints one JSON line.
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def per_leaf_blocks(torch, model, tree):
    """The per-leaf form: for every rank and leaf a tensor moved into
    shared memory and a copy from the card into it."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.runtime import MESH_AXES
    from repro_torch.training.optimizer import tree_map
    import chip_smoke as c
    mesh = Mesh(MESH_AXES[len(c.LS_MESH)], c.LS_MESH,
                (torch.device("cpu"),) * 4)
    specs = SH.param_pspecs(model.defs(), mesh)

    def block(rank):
        def cut(x, s):
            b = x[SH.NamedSharding(mesh, s).devices_indices_map(
                tuple(x.shape))[rank]]
            return torch.empty(b.shape, dtype=b.dtype).share_memory_() \
                .copy_(b)
        return cut
    return [tree_map(block(r), tree, specs)
            for r in range(len(mesh.device_list))]


def main():
    import torch
    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_leaves
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ls_blocks_probe: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    model = build_model(get_config(args.arch))
    # the config's params (bf16 at full width): the moments' shapes
    tree = model.init(torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    times = {"per_leaf": [], "segment": []}
    parts = []
    same = True
    for r in range(args.rounds):
        for name in (("per_leaf", "segment") if r % 2 == 0
                     else ("segment", "per_leaf")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "per_leaf":
                got = per_leaf_blocks(torch, model, tree)
            else:
                p = {}
                got = c._ls_rank_blocks(torch, model, tree, p)
                parts.append(p)
            times[name].append(time.perf_counter() - t)
            if name == "segment" and r == 0:
                want = per_leaf_blocks(torch, model, tree)
                same = all(torch.equal(a, b) for ra, rb in zip(got, want)
                           for a, b in zip(tree_leaves(ra),
                                           tree_leaves(rb)))
                del want
            del got
    print(json.dumps(dict(
        arch=args.arch, dtype=str(tree_leaves(tree)[0].dtype),
        tree_bytes=nbytes, rounds=args.rounds, equal=same,
        device=torch.cuda.get_device_name(0),
        seconds={k: v for k, v in times.items()},
        median={k: statistics.median(v) for k, v in times.items()},
        segment_parts=parts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
