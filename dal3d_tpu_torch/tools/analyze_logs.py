#!/usr/bin/env python
"""Training-log statistics and curves of the PyTorch port (port of JAX's
``tools/analyze_logs.py``; the reference's tools/analyze_logs.py:10-176).

    python -m dal3d_tpu_torch.tools.analyze_logs cal_train_time LOG
    python -m dal3d_tpu_torch.tools.analyze_logs plot_curve LOG [--keys loss ...] [--out curve.png]

Parses the trainer's text log (``runtime/trainer.py`` writes JAX's
interval line): ``cal_train_time`` prints each epoch's mean, std, min and
max iteration time; ``plot_curve`` draws the named keys per logged step
(matplotlib on Agg). Host only: no device.
"""
import argparse
import re

LINE = re.compile(
    r"Epoch \[(\d+)\]\[(\d+)\] lr: ([\d.e+-]+), time: ([\d.]+) \(([\d.]+) data\), "
    r"loss: ([\d.]+) \(loc ([\d.]+) / cls ([\d.]+)\)"
)


def parse(path):
    """The log's interval lines as rows {epoch, iter, lr, time, data_time,
    loss, loc_loss, cls_loss}."""
    rows = []
    with open(path) as f:
        for line in f:
            m = LINE.search(line)
            if m:
                rows.append({
                    "epoch": int(m.group(1)), "iter": int(m.group(2)),
                    "lr": float(m.group(3)), "time": float(m.group(4)),
                    "data_time": float(m.group(5)), "loss": float(m.group(6)),
                    "loc_loss": float(m.group(7)), "cls_loss": float(m.group(8)),
                })
    return rows


def cal_train_time(rows):
    import numpy as np

    by_epoch = {}
    for r in rows:
        by_epoch.setdefault(r["epoch"], []).append(r["time"])
    print(f"{'epoch':>6} {'mean_iter_time':>15} {'std':>8} {'min':>8} {'max':>8}")
    for e, ts in sorted(by_epoch.items()):
        ts = np.asarray(ts)
        print(f"{e:>6} {ts.mean():>15.4f} {ts.std():>8.4f} {ts.min():>8.4f} {ts.max():>8.4f}")


def plot_curve(rows, keys, out):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = list(range(len(rows)))
    for k in keys:
        plt.plot(xs, [r[k] for r in rows], label=k)
    plt.xlabel("log step")
    plt.legend()
    plt.savefig(out, dpi=120)
    print(f"curve -> {out}")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="task", required=True)
    t = sub.add_parser("cal_train_time")
    t.add_argument("log")
    c = sub.add_parser("plot_curve")
    c.add_argument("log")
    c.add_argument("--keys", nargs="+", default=["loss"])
    c.add_argument("--out", default="curve.png")
    return p.parse_args(argv)


def main(argv=None):
    """Runs the task; returns the parsed rows."""
    args = parse_args(argv)
    rows = parse(args.log)
    if not rows:
        print("no trainer log lines found")
        return rows
    if args.task == "cal_train_time":
        cal_train_time(rows)
    else:
        plot_curve(rows, args.keys, args.out)
    return rows


if __name__ == "__main__":
    main()
