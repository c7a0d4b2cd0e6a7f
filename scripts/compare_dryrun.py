"""Table the port's dry run beside the JAX package's, cell by cell.

Reads the port's records (``python -m repro_torch.launch.dryrun``, by
default ``results/dryrun_torch.json``) and the JAX package's (``python -m
repro.launch.dryrun --mesh single --arch all --shape all --include-graph
--out FILE``, run on the CPU) and prints, for one mesh, a row an arch and
for each shape the per-device temp GiB and collective GB (the sum of the
five kinds) as "JAX / port". The JAX side parses its collectives and
FLOPs from the compiled program, where a scanned layer's appear once.

  python scripts/compare_dryrun.py --jax /tmp/jax_dryrun.json --mesh single
"""
import argparse
import json

GiB = 2 ** 30
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", required=True, help="the JAX dry run's records")
    ap.add_argument("--port", default="results/dryrun_torch.json")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args()
    recs = {}
    for side, path in (("jax", args.jax), ("port", args.port)):
        with open(path) as f:
            for r in json.load(f):
                if r["mesh"] == args.mesh:
                    recs.setdefault(r["arch"], {}).setdefault(
                        r["shape"], {})[side] = r

    def pair(cell, value):
        if not cell:
            return "—"
        got = [cell.get(side) for side in ("jax", "port")]
        if any(r is None or r["status"] != "ok" for r in got):
            return "/".join("—" if r is None else r["status"] for r in got)
        return " / ".join(value(r) for r in got)

    def temp(r):
        return f"{r['memory']['temp_bytes'] / GiB:.2f}"

    def coll(r):
        return f"{sum(r['collective_bytes'].values()) / 1e9:.3f}"

    print("| arch | " + " | ".join(f"{s} temp GiB | {s} coll. GB"
                                   for s in SHAPES) + " |")
    print("| --- |" + " --- |" * (2 * len(SHAPES)))
    for arch, cells in sorted(recs.items()):
        row = [f"{pair(cells.get(s), temp)} | {pair(cells.get(s), coll)}"
               for s in SHAPES]
        print(f"| {arch} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
