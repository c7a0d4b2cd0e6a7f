"""The paper's link-prediction tables on the port — the offline entry point.

``python -m repro_torch.launch.tables --table github --quick --device cuda``

The torch counterpart of ``benchmarks/common.py`` (``run_model``,
``run_table``) with the settings of ``benchmarks/table_{cora,facebook,
github}.py``, plus a ``tiny`` table for a quick CPU run. Each row runs the
paper's protocol (§3.1.2): link split -> embed with DeepWalk, CoreWalk or a
k-core variant -> logistic-regression F1, with the paper's time breakdown.
It prints the JAX harness's row format and ``name,us_per_call,derived`` CSV
lines. Two choices differ from the JAX harness, both about where work runs
and neither about what is computed: SGNS dispatches with ``impl="auto"``
(the fused CUDA kernels on the card; the JAX harness passes ``"ref"``), and
the k-core rows propagate with the ``torch`` backend (the ELL-mean kernel on
the card; the JAX harness's default is the host's ``scipy``). The split of
each seed is made once and shared by the rows.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import kcore
from repro_torch.core.pipeline import EmbedConfig, embed_graph
from repro_torch.eval.linkpred import evaluate_link_prediction
from repro_torch.graph import datasets, splits
from repro_torch.skipgram.trainer import SGNSConfig

__all__ = ["BenchSettings", "ROW_FMT", "TABLES", "table", "run_model",
           "k0_of", "run_table", "csv_line", "main"]

ROW_FMT = ("{model:16s} {f1:6.2f} (±{f1_std:4.2f})  drop {drop:+5.1f}  "
           "decomp {decomposition:6.2f}s walks {walks:6.2f}s embed "
           "{embedding:7.2f}s prop {propagation:5.2f}s total {total:7.2f}s "
           "speedup x{speedup:4.1f}")


@dataclasses.dataclass
class BenchSettings:
    dataset: str
    frac_removed: float = 0.1
    n_walks: int = 15
    walk_length: int = 30
    dim: int = 150
    window: int = 4
    n_neg: int = 5
    batch: int = 8192
    epochs: float = 1.0
    seeds: int = 2
    prop_iters: int = 30


def table(name: str, quick: bool = False, frac: float = 0.1):
    """-> (settings, models) of a paper table; models are
    (label, method, k0 as a fraction of the degeneracy or None)."""
    if name == "github":  # Tables 4/9/10
        s = BenchSettings("github-like", frac, seeds=1,
                          epochs=0.25 if quick else 1.0)
        ks = (0.4,) if quick else (0.3, 0.6, 0.9)
        models = ([("DeepWalk", "deepwalk", None)]
                  + [("Dw", "deepwalk", f) for f in ks]
                  + [("CoreWalk", "corewalk", None)])
    elif name == "facebook":  # Tables 2/3/7/8
        s = BenchSettings("facebook-like", frac, seeds=1 if quick else 3,
                          epochs=0.5 if quick else 1.0)
        ks = (0.4, 0.9) if quick else (0.15, 0.4, 0.65, 0.9)
        models = ([("DeepWalk", "deepwalk", None)]
                  + [("Dw", "deepwalk", f) for f in ks]
                  + [("CoreWalk", "corewalk", None)]
                  + [("Cw", "corewalk", f) for f in ks])
    elif name == "cora":  # Tables 1/5/6: ~2-core and the degeneracy core
        s = BenchSettings("cora-like", frac, seeds=1 if quick else 3,
                          epochs=0.5 if quick else 1.0)
        models = [("DeepWalk", "deepwalk", None), ("Dw", "deepwalk", 0.55),
                  ("Dw", "deepwalk", 0.95)]
    elif name == "tiny":  # the 64-node preset: a CPU run in seconds
        s = BenchSettings("tiny", frac, seeds=1 if quick else 2,
                          epochs=0.5 if quick else 1.0)
        models = [("DeepWalk", "deepwalk", None), ("Dw", "deepwalk", 0.5),
                  ("CoreWalk", "corewalk", None)]
    else:
        raise ValueError(f"unknown table {name!r}; options: {TABLES}")
    return s, models


TABLES = ("tiny", "cora", "facebook", "github")


def run_model(sp, method: str, k0: Optional[int], s: BenchSettings,
              seed: int, device="cuda") -> Dict:
    cfg = EmbedConfig(
        method=method,
        k0=k0,
        n_walks=s.n_walks,
        walk_length=s.walk_length,
        sgns=SGNSConfig(
            dim=s.dim, window=s.window, n_neg=s.n_neg, batch=s.batch,
            epochs=s.epochs, seed=seed, impl="auto",
        ),
        prop_iters=s.prop_iters,
        prop_backend="torch",
        seed=seed,
        device=device,
    )
    t0 = time.perf_counter()
    res = embed_graph(sp.train_graph, cfg)
    total = time.perf_counter() - t0
    pairs, labels = sp.eval_arrays()
    lp = evaluate_link_prediction(res.embeddings, pairs, labels, seed=seed,
                                  device=device)
    return {
        "f1": lp.f1 * 100,
        "times": res.times,
        "total": total,
        "n_walks_run": res.n_walks_run,
        "n_sgns_steps": res.n_sgns_steps,
        "final_loss": res.final_loss,
        "degeneracy": res.degeneracy,
        "result": res,
    }


def k0_of(core: np.ndarray, frac: Optional[float]) -> Optional[int]:
    """k0 = max(2, round(degeneracy * frac)) of the full graph's cores."""
    if frac is None:
        return None
    return max(2, int(round(kcore.degeneracy(core) * frac)))


def run_table(s: BenchSettings, models: List[tuple],
              device="cuda") -> List[Dict]:
    """models: list of (label, method, k0_frac_or_None)."""
    g = datasets.load(s.dataset)
    core = kcore.core_numbers_host(g)
    sps = [splits.make_link_split(g, s.frac_removed, seed=seed)
           for seed in range(s.seeds)]
    rows = []
    baseline_time = None
    baseline_f1 = None
    for label, method, k0f in models:
        k0 = k0_of(core, k0f)
        outs = [run_model(sp, method, k0, s, seed, device)
                for seed, sp in enumerate(sps)]
        f1s = [o["f1"] for o in outs]
        mean_t = {k: float(np.mean([o["times"][k] for o in outs]))
                  for k in outs[0]["times"]}
        row = {
            "model": label if k0 is None else f"{k0}-core ({label})",
            "f1": float(np.mean(f1s)),
            "f1_std": float(np.std(f1s)),
            "total": float(np.mean([o["total"] for o in outs])),
            "sgns_steps": int(np.mean([o["n_sgns_steps"] for o in outs])),
            "n_walks_run": int(np.mean([o["n_walks_run"] for o in outs])),
            "final_loss": float(np.mean([o["final_loss"] for o in outs])),
            **{k: v for k, v in mean_t.items() if k != "total"},
        }
        if baseline_time is None:
            baseline_time, baseline_f1 = row["total"], row["f1"]
        row["speedup"] = baseline_time / row["total"]
        row["drop"] = row["f1"] - baseline_f1
        rows.append(row)
        print(ROW_FMT.format(**row), flush=True)
    return rows


def csv_line(name: str, seconds: float, derived: str) -> str:
    """``name,us_per_call,derived``, as the JAX harness prints."""
    return f"{name},{seconds * 1e6:.0f},{derived}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", default="github", choices=TABLES)
    ap.add_argument("--quick", action="store_true",
                    help="the quick settings (fewer epochs, seeds and k0s)")
    ap.add_argument("--frac", type=float, default=0.1,
                    help="fraction of edges removed for the test pairs")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the hand-written kernels) or "
                         "cpu (their plain versions)")
    args = ap.parse_args(argv)
    s, models = table(args.table, args.quick, args.frac)
    print(f"== table_{args.table} (frac={args.frac}, device={args.device}) ==")
    rows = run_table(s, models, device=args.device)
    for r in rows:
        print(csv_line(
            f"table_{args.table}_f{int(args.frac * 100)}_"
            f"{r['model'].replace(' ', '')}", r["total"],
            f"F1={r['f1']:.2f};speedup=x{r['speedup']:.1f};"
            f"walks={r['n_walks_run']};sgns_steps={r['sgns_steps']}"))
    return rows


if __name__ == "__main__":
    main()
