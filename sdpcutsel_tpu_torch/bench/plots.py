"""Paper-style figures from suite results (port of
``sdpcutsel_tpu/bench/plots.py``: the matplotlib output of the reference's
experiment runner, SURVEY.md section 2.1 R4 / 3.3).

    python -m sdpcutsel_tpu_torch.cli plot [results/suite.jsonl] [--out results/figures]

It reads the port's records (``platform`` "cuda" or "cpu") and the JAX
package's ("tpu", "cpu", or none) alike; it needs matplotlib and no card,
and nothing else of the port imports it.

Produces:
  * gap_vs_rounds_<instance>.svg — % SDP gap closed per round, one line per
    strategy (the paper's headline curve form), for each instance present.
  * gap_vs_time_<instance>.svg — same, against cumulative wall-clock (the
    paper's second axis; rendered when records carry ``round_times_s``).
  * suite_summary.svg — mean final % gap closed per strategy over the suite.
  * tpu_vs_replica_time_<instance>.svg — a record against the CPU replica's
    timing (results/replica_timing.jsonl beside the input), labelled with
    the record's platform.

Colors follow a fixed categorical order per strategy (identity encoding —
never cycled), validated palette; one y-axis; recessive grid; direct labels
on line ends plus a legend.
"""

import argparse
import json
import os
from collections import defaultdict

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

# fixed strategy -> color assignment (categorical slots 1-5; identity is
# stable across figures regardless of which strategies a file contains)
COLORS = {
    "neural": "#2a78d6",
    "feasibility": "#eb6834",
    "random": "#1baf7a",
    "triangle": "#eda100",
    "optimality": "#e87ba4",
    "combined": "#4a3aa7",
}
ORDER = list(COLORS)

TEXT = "#0b0b0b"
MUTED = "#52514e"
GRID = "#e6e5e1"


def _style(ax):
    ax.set_facecolor("#fcfcfb")
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.tick_params(colors=MUTED, labelsize=9)
    ax.grid(True, axis="y", color=GRID, linewidth=0.7)
    ax.set_axisbelow(True)


def load(path):
    """Suite records keyed [instance][strategy]; later records win (re-runs).
    Records missing the fields the figures need are skipped, so files with
    other record shapes (summaries, parity rows) don't crash rendering."""
    rows = defaultdict(dict)
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ("instance" in r and "strategy" in r
                    and r.get("gap_closed")):
                rows[r["instance"]][r["strategy"]] = r
    return rows


def plot_instance(name, recs, out_dir):
    fig, ax = plt.subplots(figsize=(5.2, 3.4), dpi=150)
    _style(ax)
    strategies = [s for s in ORDER if s in recs]
    for s in strategies:
        g = [100.0 * v for v in recs[s]["gap_closed"]]
        ax.plot(range(len(g)), g, color=COLORS[s], linewidth=2,
                marker="o", markersize=3.5, label=s)
        ax.annotate(f"{g[-1]:.0f}%", (len(g) - 1, g[-1]),
                    textcoords="offset points", xytext=(6, -3),
                    fontsize=8, color=TEXT)
    ax.set_xlabel("cutting-plane round", color=MUTED, fontsize=9)
    ax.set_ylabel("% SDP gap closed", color=MUTED, fontsize=9)
    ax.set_title(name, color=TEXT, fontsize=11, loc="left")
    if len(strategies) > 1:
        ax.legend(frameon=False, fontsize=8, labelcolor=TEXT, loc="lower right")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"gap_vs_rounds_{name}.svg"))
    plt.close(fig)


def plot_instance_time(name, recs, out_dir):
    """% gap closed vs cumulative wall-clock (the paper's second headline
    axis).  Only rendered when records carry per-round times
    (``round_times_s``); returns True if written."""
    have = [s for s in ORDER if s in recs and recs[s].get("round_times_s")]
    if not have:
        return False
    fig, ax = plt.subplots(figsize=(5.2, 3.4), dpi=150)
    _style(ax)
    for s in have:
        g = [100.0 * v for v in recs[s]["gap_closed"]]
        t, cum = [], 0.0
        for dt in recs[s]["round_times_s"]:
            cum += dt
            t.append(cum)
        m = min(len(g), len(t))
        ax.plot(t[:m], g[:m], color=COLORS[s], linewidth=2,
                marker="o", markersize=3.5, label=s)
    ax.set_xlabel("wall-clock (s)", color=MUTED, fontsize=9)
    ax.set_ylabel("% SDP gap closed", color=MUTED, fontsize=9)
    ax.set_title(name, color=TEXT, fontsize=11, loc="left")
    if len(have) > 1:
        ax.legend(frameon=False, fontsize=8, labelcolor=TEXT, loc="lower right")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"gap_vs_time_{name}.svg"))
    plt.close(fig)
    return True


def plot_tpu_vs_replica_time(name, tpu_rec, timing_rec, out_dir):
    """A suite record vs the CPU replica, % gap closed against WALL-CLOCK,
    one large-n instance per figure (the paper's second axis anchored
    against the reference stack's own timing), the record's line labelled
    with its ``platform`` (the JAX package's older records carry none: TPU).
    The replica record comes from scripts/bench_gap_vs_time.py (its score/lp
    times are cumulative); gap closed uses the same registry (mc, sdp)
    normalization as the suite record."""
    platform = tpu_rec.get("platform", "tpu").upper()
    mc, sdp = tpu_rec["mccormick"], tpu_rec["sdp"]
    denom = mc - sdp
    if denom <= 0 or not tpu_rec.get("round_times_s"):
        return False
    fig, ax = plt.subplots(figsize=(5.2, 3.4), dpi=150)
    _style(ax)
    g = [100.0 * v for v in tpu_rec["gap_closed"]]
    t, cum = [], 0.0
    for dt in tpu_rec["round_times_s"]:
        cum += dt
        t.append(cum)
    m = min(len(g), len(t))
    ax.plot(t[:m], g[:m], color=COLORS.get(tpu_rec["strategy"], TEXT),
            linewidth=2, marker="o", markersize=3.5,
            label=f"{platform} ({tpu_rec['strategy']})")
    rb = timing_rec["bounds"]
    rg = [100.0 * max(0.0, min(1.0, (mc - b) / denom)) for b in rb]
    rt = [s + l for s, l in zip(timing_rec["score_time_s"],
                                timing_rec["lp_time_s"])]  # cumulative
    ax.plot(rt, rg, color="#b8860b", linewidth=2, linestyle="--",
            marker="s", markersize=3.5,
            label=f"CPU replica ({timing_rec['strategy']})")
    ax.set_xlabel("wall-clock (s)", color=MUTED, fontsize=9)
    ax.set_ylabel("% SDP gap closed", color=MUTED, fontsize=9)
    ax.set_xscale("log")
    ax.set_title(f"{name} — {platform} vs reference stack", color=TEXT,
                 fontsize=11, loc="left")
    ax.legend(frameon=False, fontsize=8, labelcolor=TEXT, loc="lower right")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"tpu_vs_replica_time_{name}.svg"))
    plt.close(fig)
    return True


def plot_summary(rows, out_dir):
    """Renders the mean-final-gap bar chart; returns True if written."""
    sums = defaultdict(list)
    for recs in rows.values():
        for s, r in recs.items():
            sums[s].append(100.0 * r["final_gap_closed"])
    strategies = [s for s in ORDER if s in sums]
    if not strategies:
        return False
    means = [sum(sums[s]) / len(sums[s]) for s in strategies]
    fig, ax = plt.subplots(figsize=(4.6, 3.0), dpi=150)
    _style(ax)
    bars = ax.bar(strategies, means,
                  color=[COLORS[s] for s in strategies], width=0.62)
    for b, m, s in zip(bars, means, strategies):
        ax.annotate(f"{m:.1f}%", (b.get_x() + b.get_width() / 2, m),
                    ha="center", va="bottom", fontsize=9, color=TEXT)
    ax.set_ylabel("mean final % SDP gap closed", color=MUTED, fontsize=9)
    ax.set_title(
        f"BoxQP suite ({len(rows)} instances)", color=TEXT, fontsize=11,
        loc="left",
    )
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "suite_summary.svg"))
    plt.close(fig)
    return True


def render_all(path, out_dir):
    """Shared entry point for the CLI and the module main: render every
    per-instance figure plus the summary.  Returns the figure count."""
    os.makedirs(out_dir, exist_ok=True)
    rows = load(path)
    count = 0
    for name, recs in sorted(rows.items()):
        plot_instance(name, recs, out_dir)
        count += 1
        if plot_instance_time(name, recs, out_dir):
            count += 1
    if plot_summary(rows, out_dir):
        count += 1
    timing_path = os.path.join(os.path.dirname(path), "replica_timing.jsonl")
    if os.path.exists(timing_path):
        with open(timing_path) as f:
            for line in f:
                try:
                    tr = json.loads(line)
                except json.JSONDecodeError:
                    continue
                recs = rows.get(tr.get("instance"), {})
                tpu = recs.get(tr.get("strategy")) or recs.get("neural")
                if tpu and plot_tpu_vs_replica_time(
                        tr["instance"], tpu, tr, out_dir):
                    count += 1
    return count


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="results/suite.jsonl")
    ap.add_argument("--out", default="results/figures")
    args = ap.parse_args()
    n = render_all(args.path, args.out)
    print(f"wrote {n} figures to {args.out}")


if __name__ == "__main__":
    main()
