"""Command-line interface: `python -m moshpp_torch <subcommand>` (port of
`moshpp_tpu/cli.py`).

The reference ships no CLI — it is driven as a library through
`run_moshpp_once(cfg)` (mosh_head.py:584-606). This wraps the same session
API so single sequences can be solved, exported and inspected from a shell
without writing a driver script:

  run      MOCAP     — stage-i + stage-ii on one sequence (cached on disk)
  run-many MOCAPS    — many sequences through the fleet runner
  export   PKL       — stage-ii pickle -> AMASS-format npz
  layout   PKL       — the optimized marker layout of a stage-i pickle
  view     MOCAP     — a self-contained HTML player of the trajectories
  info     MOCAP     — print mocap metadata (frames, rate, labels, subjects)

All config is the same base-config + dotlist-override scheme as the library
(`config/moshpp_conf.json`); `-o key=value` maps 1:1 to dotted config keys
with YAML-typed values (read without PyYAML, `config/yaml_values.py`). The
solves run on `--device` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from moshpp_torch.config.yaml_values import parse_value


def _parse_overrides(pairs):
    out = {}
    for kv in pairs or ():
        if "=" not in kv:
            raise SystemExit(f"override must be key=value, got: {kv!r}")
        k, v = kv.split("=", 1)
        try:
            out[k.strip()] = parse_value(v) if v != "" else None
        except ValueError as e:
            raise SystemExit(f"override {kv!r}: {e}") from e
    return out


def _common_cfg(args) -> dict:
    """Shared run/run-many flag -> dotted-config-key mapping."""
    cfg = {}
    if args.work_dir:
        cfg["dirs.work_base_dir"] = args.work_dir
    if args.support_dir:
        cfg["dirs.support_base_dir"] = args.support_dir
    if args.model:
        cfg["surface_model.fname"] = args.model
    if args.model_type:
        cfg["surface_model.type"] = args.model_type
    if args.layout:
        cfg["dirs.marker_layout.fname"] = args.layout
    if args.stagei_only:
        cfg["runtime.stagei_only"] = True
    cfg.update(_parse_overrides(args.override))
    return cfg


def _cmd_run(args) -> int:
    from moshpp_torch.pipeline.head import run_moshpp_once
    from moshpp_torch.io.amass import load_as_amass_npz

    cfg = {"mocap.fname": args.mocap, **_common_cfg(args)}

    mp = run_moshpp_once(cfg, device=args.device)
    print(f"stagei:  {mp.stagei_fname}")
    if mp.stageii_data is not None:
        errs = mp.stageii_data["stageii_debug_details"]["stageii_errs"]
        print(f"stageii: {mp.stageii_fname}")
        print(f"mean data err: "
              f"{1000.0 * float(np.mean(errs['data_mean_m'])):.4f} mm")
        if args.npz:
            load_as_amass_npz(mp.stageii_fname, stageii_npz_fname=args.npz,
                              include_markers=args.include_markers)
            print(f"npz:     {args.npz}")
    return 0


def _cmd_run_many(args) -> int:
    import glob as _glob
    import os

    from moshpp_torch.pipeline.fleet import run_moshpp_fleet

    fnames = []
    for pat in args.mocaps:
        if any(c in pat for c in "*?["):
            hits = sorted(_glob.glob(pat, recursive=True))
            if not hits:
                raise SystemExit(f"no files match pattern: {pat!r}")
            fnames.extend(hits)
        else:
            if not os.path.exists(pat):
                raise SystemExit(f"mocap file not found: {pat!r}")
            fnames.append(pat)
    base = _common_cfg(args)
    jobs = [{**base, "mocap.fname": f} for f in fnames]

    report = run_moshpp_fleet(jobs, processes=args.processes,
                              only_stagei=args.stagei_only,
                              determine_shape_for_each_seq=args.per_seq_shape,
                              stop_on_error=args.stop_on_error,
                              device=args.device)
    for r in report.results:
        line = f"{r.status:9s} {r.job.get('mocap.fname')}"
        if r.status == "ok":
            line += f"  ({r.elapsed_s:.1f}s)"
        print(line)
    print(report.summary())
    return 1 if report.num_failed else 0


def _cmd_export(args) -> int:
    from moshpp_torch.io.amass import load_as_amass_npz, load_as_amass_npz_legacy

    fn = load_as_amass_npz_legacy if args.legacy else load_as_amass_npz
    out = fn(args.stageii_pkl, stageii_npz_fname=args.output,
             stagei_npz_fname=args.stagei_npz,
             include_markers=args.include_markers)
    print(f"wrote {args.output} "
          f"(poses {np.asarray(out['poses']).shape}, keys: "
          f"{', '.join(sorted(out))})")
    return 0


def _cmd_layout(args) -> int:
    from moshpp_torch.pipeline.head import MoSh

    MoSh.dump_stagei_marker_layout(
        args.stagei_pkl, out_marker_layout_fname=args.output,
        template_marker_layout_fname=args.template, device=args.device)
    out = args.output or str(args.stagei_pkl).replace(".pkl", ".json")
    print(f"layout: {out}")
    return 0


def _cmd_view(args) -> int:
    from moshpp_torch.io.mocap import MocapSession
    from moshpp_torch.tools.visualization import play_mocap_trajectories

    import os

    sess = MocapSession(args.mocap, mocap_unit=args.unit)
    out = args.output or (os.path.splitext(str(args.mocap))[0] + ".html")
    play_mocap_trajectories(np.asarray(sess.markers), out,
                            labels=list(sess.labels),
                            frame_rate=sess.frame_rate,
                            title=str(args.mocap))
    print(f"player: {out}")
    return 0


def _cmd_info(args) -> int:
    from moshpp_torch.io.mocap import MocapSession

    sess = MocapSession(args.mocap, mocap_unit=args.unit)
    markers = np.asarray(sess.markers)
    avail = np.asarray(sess.availability_mask())
    info = {
        "fname": str(args.mocap),
        "frame_rate": float(sess.frame_rate),
        "num_frames": int(markers.shape[0]),
        "num_markers": int(markers.shape[1]),
        "time_length_s": float(sess.time_length()),
        "subjects": sorted(sess.subject_names or []),
        "mean_marker_availability": float(avail.mean()) if avail.size else 0.0,
    }
    if args.labels:
        info["labels"] = list(sess.labels)
    print(json.dumps(info, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="moshpp_torch",
        description="MoSh++ on PyTorch and CUDA: labeled optical mocap -> "
                    "SMPL-family body parameters.")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="solve one mocap sequence (stage-i + "
                                   "stage-ii, results cached on disk)")
    r.add_argument("mocap", help="labeled mocap file (.c3d/.npz/.pkl/.mat), "
                                 "path convention .../ds_name/session/name.ext")
    r.add_argument("--work-dir", help="dirs.work_base_dir (outputs + cache)")
    r.add_argument("--support-dir",
                   help="dirs.support_base_dir (model files + priors)")
    r.add_argument("--model", help="surface_model.fname override")
    r.add_argument("--model-type",
                   help="surface_model.type (smpl/smplh/smplx/mano/...)")
    r.add_argument("--layout", help="marker layout JSON "
                                    "(dirs.marker_layout.fname)")
    r.add_argument("--stagei-only", action="store_true",
                   help="stop after shape/latent-marker estimation")
    r.add_argument("--npz", help="also export the stage-ii result as an "
                                 "AMASS-format npz to this path")
    r.add_argument("--include-markers", action="store_true",
                   help="include observed/simulated markers in the npz")
    r.add_argument("--device", default="cuda",
                   help="torch device the solves run on (default cuda; cpu "
                        "to run without a card)")
    r.add_argument("-o", "--override", action="append", metavar="KEY=VALUE",
                   help="dotted config override (YAML-typed), e.g. "
                        "-o opt_settings.maxiter=50 -o mocap.ds_rate=2")
    r.set_defaults(fn=_cmd_run)

    m = sub.add_parser("run-many", help="solve many sequences (job dedup + "
                                        "idempotent caching; crash-safe rerun)")
    m.add_argument("mocaps", nargs="+",
                   help="mocap files and/or glob patterns")
    m.add_argument("--work-dir", help="dirs.work_base_dir (outputs + cache)")
    m.add_argument("--support-dir",
                   help="dirs.support_base_dir (model files + priors)")
    m.add_argument("--model", help="surface_model.fname override")
    m.add_argument("--model-type",
                   help="surface_model.type (smpl/smplh/smplx/mano/...)")
    m.add_argument("--layout", help="marker layout JSON "
                                    "(dirs.marker_layout.fname)")
    m.add_argument("--stagei-only", action="store_true",
                   help="run/keep only stage-i jobs")
    m.add_argument("--device", default="cuda",
                   help="torch device the solves run on (default cuda; cpu "
                        "to run without a card)")
    m.add_argument("--processes", type=int, default=1,
                   help="worker processes (spawned; keep 1 on one card)")
    m.add_argument("--stop-on-error", action="store_true")
    m.add_argument("--per-seq-shape", action="store_true",
                   help="estimate shape per sequence instead of sharing "
                        "stage-i per subject")
    m.add_argument("-o", "--override", action="append", metavar="KEY=VALUE",
                   help="dotted config override applied to every job")
    m.set_defaults(fn=_cmd_run_many)

    e = sub.add_parser("export", help="stage-ii pickle -> AMASS npz")
    e.add_argument("stageii_pkl")
    e.add_argument("-O", "--output", required=True, help="output npz path")
    e.add_argument("--stagei-npz", help="also write the shape-only stage-i "
                                        "npz subset to this path")
    e.add_argument("--include-markers", action="store_true")
    e.add_argument("--legacy", action="store_true",
                   help="read a legacy (pre-2021 schema) stage-ii pickle")
    e.set_defaults(fn=_cmd_export)

    l = sub.add_parser("layout", help="dump the optimized marker layout "
                                      "from a stage-i pickle (JSON + PLY/C3D "
                                      "inspection artifacts)")
    l.add_argument("stagei_pkl")
    l.add_argument("-O", "--output", help="output layout JSON path "
                                          "(default: alongside the pkl)")
    l.add_argument("--template", help="template layout JSON whose marker "
                                      "types/colors to keep")
    l.add_argument("--device", default="cuda",
                   help="torch device the solves run on (default cuda; cpu "
                        "to run without a card)")
    l.set_defaults(fn=_cmd_layout)

    v = sub.add_parser("view", help="write a self-contained interactive "
                                    "HTML player for a mocap file")
    v.add_argument("mocap")
    v.add_argument("-O", "--output", help="output .html (default: next to "
                                          "the mocap)")
    v.add_argument("--unit", default="mm", help="mocap unit (mm/cm/m)")
    v.set_defaults(fn=_cmd_view)

    i = sub.add_parser("info", help="print mocap metadata as JSON")
    i.add_argument("mocap")
    i.add_argument("--unit", default="mm", help="mocap unit (mm/cm/m)")
    i.add_argument("--labels", action="store_true",
                   help="include the full label list")
    i.set_defaults(fn=_cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
