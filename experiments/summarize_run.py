"""Summarize a convergence run's metrics.jsonl into the BASELINE.md
"Measured" table: per-frame NRC-vs-MC MSE/relBias/CV, warmup crossover,
and tail-window means.

Usage: python experiments/summarize_run.py output/<run dir> [tail_n]
"""
import json
import sys


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def mean(xs):
    xs = list(xs)
    return sum(xs) / max(len(xs), 1)


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    d = sys.argv[1]
    tail_n = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    rows = [r for r in load(f"{d}/metrics.jsonl") if "nrc" in r]
    n = len(rows)
    if not n:
        print("no comparison rows found")
        return
    tail = rows[-tail_n:]
    nrc_mse = [r["nrc"]["mse"] for r in tail]
    mc_mse = [r["mc"]["mse"] for r in tail if "mc" in r]
    wins = sum(1 for r in rows if "mc" in r
               and r["nrc"]["mse"] < r["mc"]["mse"])
    first_win = next((r["frame"] for r in rows if "mc" in r
                      and r["nrc"]["mse"] < r["mc"]["mse"]), None)
    print(f"frames with comparison: {n}")
    print(f"NRC beats MC on {wins}/{n} frames (first win: frame "
          f"{first_win})")
    print(f"tail({tail_n}) NRC  mse {mean(nrc_mse):.4f}  relBias "
          f"{mean(r['nrc']['rel_bias'] for r in tail):+.4f}  cv "
          f"{mean(r['nrc']['cv'] for r in tail):.3f}")
    if mc_mse:
        print(f"tail({tail_n}) MC   mse {mean(mc_mse):.4f}  relBias "
              f"{mean(r['mc']['rel_bias'] for r in tail):+.4f}  cv "
              f"{mean(r['mc']['cv'] for r in tail):.3f}")
        print(f"tail NRC/MC mse ratio: {mean(nrc_mse)/mean(mc_mse):.3f}")
    ft = [r["frame_time_ms"] for r in rows if "frame_time_ms" in r]
    if ft:
        print(f"mean frame_time_ms (incl. both renderers + per-frame "
              f"compares): {mean(ft[1:]):.0f}")
    losses = [r["loss"] for r in rows if "loss" in r]
    if losses:
        print(f"loss: first {losses[0]:.3f}  last {losses[-1]:.3f}")
    print()
    print("| frame | NRC mse | MC mse | NRC relBias | NRC cv |")
    print("|---|---|---|---|---|")
    step = max(1, n // 16)
    for r in rows[::step]:
        mc = r.get("mc", {})
        print(f"| {r['frame']} | {r['nrc']['mse']:.4f} | "
              f"{mc.get('mse', float('nan')):.4f} | "
              f"{r['nrc']['rel_bias']:+.4f} | {r['nrc']['cv']:.3f} |")


if __name__ == "__main__":
    main()
