"""Evaluation vs FSCT outputs on labeled plots (port of
pointstowood_tpu/tools/compare.py on column tables, with no pandas or
sklearn).

Reimplements the reference comparetofsct.py
(reference: pointstowood/comparetofsct.py:26-168): pair ``*_fsct.ply`` with
``*_ours.ply`` files in a directory, filter FSCT's label==2 class handling,
binarize labels, compute precision / recall / balanced accuracy / F1 (and
path-length-weighted balanced accuracy when a ``pathlength`` column is
present) against the ``truth`` column, group by country code in the file
name (pol/spa/fin -> Poland/Spain/Finland), and write results.csv
(+results.png when matplotlib is available). The scores are
``tools/scores.py``'s; ``results.csv`` has the rows, columns and values
of the JAX tool's ``summary.to_csv``.

Run: python -m pointstowood_tpu_torch.tools.compare <directory>
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from pointstowood_tpu_torch.io import load_file
from pointstowood_tpu_torch.tools import scores

_COUNTRIES = {"pol": "Poland", "spa": "Spain", "fin": "Finland"}
# the columns a summary groups by, in the JAX tool's groupby order
KEYS = ("country", "model")


def _evaluate(pc: dict) -> dict:
    truth = (np.asarray(pc["truth"]) > 0).astype(int)
    pred = (np.asarray(pc["label"]) > 0).astype(int)
    row = {
        "precision": scores.precision(truth, pred),
        "recall": scores.recall(truth, pred),
        "balanced_accuracy": scores.balanced_accuracy(truth, pred),
        "f1": scores.f1(truth, pred),
    }
    if "pathlength" in pc:
        w = np.asarray(pc["pathlength"])
        w = w / max(w.max(), 1e-12)
        row["weighted_balanced_accuracy"] = scores.balanced_accuracy(
            truth, pred, sample_weight=w
        )
    return row


def country_of(path: str) -> str:
    name = os.path.basename(path).lower()
    for code, country in _COUNTRIES.items():
        if code in name:
            return country
    return "Other"


def _table(rows: list) -> dict:
    """Row dicts -> a column table, columns in order of first appearance,
    a missing number as NaN (the JAX tool's ``pd.DataFrame(rows)``)."""
    names = list(dict.fromkeys(c for row in rows for c in row))
    return {c: np.asarray([row.get(c, np.nan) for row in rows])
            for c in names}


def compare_directory(directory: str, ours_suffix: str = "_ours.ply",
                      rival_suffix: str = "_fsct.ply") -> dict:
    """One row per (plot, model) with its scores, as a column table (empty
    where no pair is found)."""
    rows = []
    pattern = os.path.join(directory, f"*{rival_suffix}")
    for rival_path in sorted(glob.glob(pattern)):
        ours_path = rival_path.replace(rival_suffix, ours_suffix)
        if not os.path.exists(ours_path):
            continue
        rival = load_file(rival_path)
        ours = load_file(ours_path)
        # FSCT convention: its label column uses 2 for wood; binarize
        if "label" in rival:
            rival = dict(rival)
            rival["label"] = (rival["label"] == 2).astype(float)
        for model, pc in (("fsct", rival), ("ours", ours)):
            if "truth" not in pc or "label" not in pc:
                continue
            row = _evaluate(pc)
            plot = os.path.basename(rival_path).replace(rival_suffix, "")
            row.update({"plot": plot, "model": model,
                        "country": country_of(rival_path)})
            rows.append(row)
    return _table(rows)


def summarise(table: dict) -> dict:
    """The mean of each score per (country, model), groups in sorted
    order, NaN skipped, rounded to 3 places (the JAX tool's
    ``groupby(["country", "model"]).mean(numeric_only=True).round(3)``),
    as a column table led by the two keys."""
    metrics = [c for c in table
               if c not in KEYS and table[c].dtype.kind == "f"]
    groups = sorted(set(zip(*(table[k].tolist() for k in KEYS))))
    out = {k: np.asarray([g[i] for g in groups]) for i, k in enumerate(KEYS)}
    for c in metrics:
        means = []
        for g in groups:
            sel = np.logical_and.reduce(
                [table[k] == v for k, v in zip(KEYS, g)])
            vals = table[c][sel]
            vals = vals[~np.isnan(vals)]
            means.append(vals.mean() if len(vals) else np.nan)
        out[c] = np.round(np.asarray(means, np.float64), 3)
    return out


def write_csv(path: str, summary: dict) -> None:
    """``summary`` as ``DataFrame.to_csv`` writes it: a header of every
    column, one line per group, floats in their shortest repr, NaN empty."""
    def cell(v):
        if isinstance(v, (float, np.floating)):
            return "" if np.isnan(v) else repr(float(v))
        return str(v)

    names = list(summary)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(len(summary[names[0]])):
            f.write(",".join(cell(summary[c][i]) for c in names) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("directory")
    p.add_argument("--ours-suffix", default="_ours.ply")
    p.add_argument("--rival-suffix", default="_fsct.ply")
    args = p.parse_args(argv)

    table = compare_directory(args.directory, args.ours_suffix,
                              args.rival_suffix)
    if not table:
        print("no paired files found")
        return
    summary = summarise(table)
    names = list(summary)
    print("  ".join(names))
    for i in range(len(summary["model"])):
        print("  ".join(str(summary[c][i]) for c in names))
    out_csv = os.path.join(args.directory, "results.csv")
    write_csv(out_csv, summary)
    print(f"Saved {out_csv}")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        countries = sorted(set(summary["country"].tolist()))
        models = sorted(set(summary["model"].tolist()))
        fig, ax = plt.subplots(figsize=(8, 4))
        width = 0.8 / len(models)
        for j, m in enumerate(models):
            ba = [summary["balanced_accuracy"][
                      (summary["country"] == c) & (summary["model"] == m)]
                  for c in countries]
            ax.bar(np.arange(len(countries)) + j * width,
                   [v[0] if len(v) else np.nan for v in ba], width, label=m)
        ax.set_xticks(np.arange(len(countries)) + 0.4 - width / 2)
        ax.set_xticklabels(countries)
        ax.set_ylabel("balanced accuracy")
        ax.legend(title="model")
        fig.tight_layout()
        fig.savefig(os.path.join(args.directory, "results.png"), dpi=150)
        print(f"Saved {os.path.join(args.directory, 'results.png')}")
    except Exception:
        pass


if __name__ == "__main__":
    main()
