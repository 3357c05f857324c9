"""Rewrite README's table of the port's numbers from its bench report
(counterpart of the repository's tools/update_readme_perf.py, whose
columns it keeps).

    python -m dustraytracer_tpu_torch.tools.update_readme_perf
        [--report results/bench_report_torch.json] [--readme README.md]

The table lives between BEGIN and END in the README's port section and is
rewritten mechanically from the report that tools/bench_scenes.py writes;
the text outside the markers, the JAX package's table included, is kept
byte for byte. The footnote names the card as the report's nvidia-smi
line gives it. Missing markers raise."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
REPORT = ROOT / "results" / "bench_report_torch.json"
README = ROOT / "README.md"
BEGIN = ("<!-- TORCH_BENCH_TABLE_BEGIN "
         "(dustraytracer_tpu_torch/tools/update_readme_perf.py) -->")
END = "<!-- TORCH_BENCH_TABLE_END -->"


def _fmt(entry: dict, key: str, pattern: str, bold: bool = False) -> str:
    value = entry.get(key)
    if value is None:
        return "—"
    text = pattern.format(value)
    return f"**{text}**" if bold else text


def render_table(report: dict) -> str:
    rows = ["| Config | full render fwd | fwd+bwd | traversal kernel "
            "| SoL raw | volume eff |",
            "|---|---|---|---|---|---|"]
    for c in report["configs"]:
        w, h = c["size"]
        label = (f"{c['config']} {w}x{h} b{c['bounces']}: {c['scene']} "
                 f"({c['triangles']:,} tris)")
        rows.append(
            f"| {label} | {_fmt(c, 'fwd_mrays_per_s', '{:.1f} Mrays/s')} | "
            f"{_fmt(c, 'fwdbwd_mrays_per_s', '{:.1f} Mrays/s', True)} | "
            f"{_fmt(c, 'traversal_mrays_per_s', '{:.1f} Mrays/s')} | "
            f"{_fmt(c, 'sol_raw_pct', '{:.0f}%')} | "
            f"{_fmt(c, 'vol_eff_pct', '{:.0f}%', True)} |")
    card = report.get("nvidia_smi")
    where = (f"card: {card} (nvidia-smi name, power limit)" if card
             else "a CPU run: host-clock rates of the CPU twins, not a "
             "card's")
    rows += ["", f"({where}; host-clock seconds per sample or step by "
             "delta timing, `tools/bench_scenes.py` → "
             "`results/bench_report_torch.json`; SoL raw = K1's measured "
             "time against its chain-calibrated rate model, unclipped, on "
             "the pixel-order camera wave; volume eff = useful vs executed "
             "traversal work, `utils/roofline.py::volume_efficiency`)"]
    return "\n".join(rows)


def rewrite(text: str, table: str) -> str:
    """`text` with the part between BEGIN and END replaced by `table`."""
    if BEGIN not in text or END not in text:
        raise ValueError(f"README markers missing: {BEGIN} / {END}")
    pre, rest = text.split(BEGIN, 1)
    _old, post = rest.split(END, 1)
    return pre + BEGIN + "\n" + table + "\n" + END + post


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dustraytracer_tpu_torch.tools.update_readme_perf")
    p.add_argument("--report", default=str(REPORT))
    p.add_argument("--readme", default=str(README))
    args = p.parse_args(argv)
    report = json.loads(Path(args.report).read_text())
    path = Path(args.readme)
    path.write_text(rewrite(path.read_text(), render_table(report)))
    print(f"{args.readme}: port table rewritten from {args.report}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
