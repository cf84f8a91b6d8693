"""The readings each cell's limits are set from; the benchmark's own runs do
not run this.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--controls tf32,fp8]

For each seed, in one process: the program's timed path over one group of
the cell's batches (``run_batches_pipelined``, as a run drives it) and its
numbers against the f32 reference on the rows a run would check (the lower
readings); then each control, the reference computed at that precision
(by default the configuration's ``control``: the precision below its own)
in the program's place, against the f32 reference on the same rows (the
upper readings). Prints one JSON line a seed, with the program's readings of
each batch and each checked row's widest root gap beside each control's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--groups", type=int, default=1, help="groups of batches the program runs")
    p.add_argument("--controls", default="", help="comma-separated precisions; default the configuration's control")
    args = p.parse_args(argv)
    import torch

    from benchmark import check, inputs, run, spec
    from benchmark.reference import Reference
    from benchmark.spans import Capture
    from egoego_release_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        run.log("no CUDA device")
        return 2
    cell = spec.load_cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    controls = [c for c in args.controls.split(",") if c] or [cfg["control"]]
    ck.build()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        pipeline, weights = run.build_program(cfg, seed, "cuda")
        capture = Capture()
        g = traffic["group_batches"]
        ids = list(range(g * args.groups))
        results = {}
        with capture.installed(pipeline):
            for k in range(0, len(ids), g):
                capture.batch = k
                results.update(zip(ids[k: k + g], run.run_group(pipeline, traffic, seed, ids[k: k + g], "cuda")))
        rows = run.checked(seed, ids, traffic)
        produced = {i: check.rows_to_device(capture.out[i], rows[i]) for i in rows}
        del pipeline, capture
        torch.cuda.empty_cache()
        stats, offsets = inputs.norm_stats(seed), inputs.skeleton(seed)
        ref = Reference(cfg, weights, offsets, stats)
        readings, root_by_row = {"program": [], **{c: [] for c in controls}}, {}
        for i in sorted(rows):
            params = inputs.motion_batch(seed, i, traffic["batch_seqs"], traffic["frames"])
            want = ref.run_batch(params, inputs.batch_noise("cuda", seed, i), rows[i])
            by_row = lambda root: (root.to(want["root"].device, torch.float64) - want["root"]).abs().amax(-1).amax(-1)
            readings["program"].append(check.gaps(produced[i], [results[i][j] for j in rows[i]], want))
            root_by_row[i] = {"program": by_row(produced[i]["root_pos"]).tolist()}
            for c in controls:
                got = Reference(cfg, weights, offsets, stats, precision=c).run_batch(
                    params, inputs.batch_noise("cuda", seed, i), rows[i])
                readings[c].append(check.gaps({"local": got["local"], "root_pos": got["root"], "jpos": got["jpos"]},
                                              got["metrics"], want))
                root_by_row[i][c] = by_row(got["root"]).tolist()
        line = {"workload": cell.name, "seed": seed, "rows": rows, **{k: check.widest(v) for k, v in readings.items()},
                "per_batch": readings["program"], "root_gap_of_rows": root_by_row,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
