"""``fdrp-torch`` command line: detect / train / scan / pipeline / gen-json /
eval / bench (port of ``pipeline/cli.py``).

Mirrors the reference CLIs (``--video``, ``--person``, ``--live`` of
``run_pipeline.py:156-182`` and the per-stage scripts) as subcommands of
one binary, with every hard-coded reference constant exposed through
``--config`` (JSON of :class:`..config.PipelineConfig`).  Every option of
the JAX package's ``fdrp`` is here, plus ``--device``: where the
computation runs, the CUDA device unless another is named (``cpu``).
``bench`` runs :func:`..bench.headline` and prints its JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from face_detection_recognization_pca_tpu_torch.config import PipelineConfig


def _load_config(path) -> PipelineConfig:
    if not path:
        return PipelineConfig()
    with open(path) as f:
        return PipelineConfig.from_json(f.read())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fdrp-torch",
        description="Eigenfaces face detection + recognition on PyTorch (CUDA)",
    )
    p.add_argument("--config", help="PipelineConfig JSON file")
    p.add_argument(
        "--device",
        default=None,
        help="torch device to compute on (default: the CUDA device; 'cpu' runs on the CPU)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="video -> face crops + detection JSON")
    d.add_argument("--video", required=True)
    d.add_argument("--person", required=True)
    d.add_argument("--output-root", default=None)
    d.add_argument("--max-frames", type=int, default=None)
    d.add_argument(
        "--v1",
        action="store_true",
        help="v1 generation: 20px-padded 100x100 crops, "
        "{person}_face_NNNN.jpg naming, resumable ids, video metadata JSON",
    )

    t = sub.add_parser("train", help="crops -> PCA model artifacts")
    t.add_argument("--person", help="single person (train-v4 mode)")
    t.add_argument("--all", action="store_true", help="all persons (train-v5 mode)")
    t.add_argument("--lock-dir", default=None)
    t.add_argument(
        "--v1",
        action="store_true",
        help="v1 snapshot training of dark+light models from faces/{Dark,Light}_version",
    )
    t.add_argument("--base-dir", default="faces", help="v1: base faces dir")
    t.add_argument("--model-dir", default="models", help="v1: model output dir")
    t.add_argument(
        "--enhanced",
        action="store_true",
        help="multi-feature ensemble model (HOG/LBP/multi-scale + augmentation)",
    )

    s = sub.add_parser("scan", help="recognize faces in video/live stream")
    s.add_argument("--video", help="video path (guided mode with --person)")
    s.add_argument("--person", help="guided scan against this person's model")
    s.add_argument(
        "--live",
        action="store_true",
        help="webcam scan: guided single-person mode with --person, "
        "multi-model (v4) mode without",
    )
    s.add_argument("--multi", action="store_true", help="multi-model scan on --video")
    s.add_argument(
        "--batched",
        action="store_true",
        help="with --multi: frame-batched detection + size-grouped PCA "
        "verification (throughput mode; same records)",
    )
    s.add_argument(
        "--batch-frames", type=int, default=None, help="frames per device batch for --batched"
    )
    s.add_argument(
        "--haar-multi",
        action="store_true",
        help="Haar detection + all-model verification (v3 mode)",
    )
    s.add_argument(
        "--tracked",
        action="store_true",
        help="batched tracker path on --video with --person (throughput mode)",
    )
    s.add_argument(
        "--enhanced", action="store_true", help="enhanced ensemble scan on --video with --person"
    )
    s.add_argument(
        "--dual",
        nargs="+",
        metavar="MODEL_PKL",
        help="v1 dual dark/light scan with these model pickles",
    )
    s.add_argument(
        "--template-detect",
        action="store_true",
        help="with --dual: detect by full-frame multi-template TM_CCOEFF "
        "(scales 0.5-1.6, <=10 templates/dir under --faces-dir) instead of Haar",
    )
    s.add_argument(
        "--faces-dir", default="faces", help="template source directory for --template-detect"
    )
    s.add_argument("--output", default=None)
    s.add_argument("--lock-dir", default=None)
    s.add_argument("--max-frames", type=int, default=None)

    r = sub.add_parser("pipeline", help="detect -> train -> recognize")
    r.add_argument("--video")
    r.add_argument("--person", required=True)
    r.add_argument("--live", action="store_true")
    r.add_argument("--max-frames", type=int, default=None)
    r.add_argument("--no-scan", action="store_true")

    g = sub.add_parser(
        "gen-json",
        help="backfill detection JSONs from bare crop directories "
        "(the reference's standalone generate_detection_json.py)",
    )
    g.add_argument("--lock-dir", default=None)
    g.add_argument("--person", help="one person only (default: all dirs)")
    g.add_argument(
        "--force",
        action="store_true",
        help="regenerate even when the JSON already exists "
        "(the reference skips existing files)",
    )

    e = sub.add_parser("eval", help="top-1 accuracy on a holdout split")
    e.add_argument("--lock-dir", default="faces/lock_version")
    e.add_argument("--holdout-every", type=int, default=5)
    e.add_argument("--components", type=int, default=100)
    e.add_argument("--max-per-person", type=int, default=None)

    b = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    b.add_argument("--streams", type=int, default=8)
    b.add_argument("--frames", type=int, default=64, help="frame batches per dispatch")
    b.add_argument("--size", default="1080p", choices=["1080p", "720p", "544p"])
    return p


def _detect(args, cfg, device) -> int:
    from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
    from face_detection_recognization_pca_tpu_torch.pipeline.detect_app import (
        detect_video,
        detect_video_v1,
    )

    detector = HaarDetector(device=device)
    if args.v1:
        meta = detect_video_v1(
            args.video, args.output_root or cfg.paths.faces_root, args.person, config=cfg,
            detector=detector, max_frames=args.max_frames,
        )
        print(json.dumps({"faces": len(meta["faces"])}))
        return 0
    det = detect_video(
        args.video, args.person, output_root=args.output_root, config=cfg, detector=detector,
        max_frames=args.max_frames,
    )
    print(json.dumps({"faces": det.total_faces_detected, "frames": det.total_frames}))
    return 0


def _train(p, args, cfg, device) -> int:
    from face_detection_recognization_pca_tpu_torch.pipeline.train_app import (
        _load_person_crops,
        train_all_persons,
        train_single_person,
    )

    if args.v1:
        from face_detection_recognization_pca_tpu_torch.pipeline.v1_apps import train_v1_versions

        paths = train_v1_versions(
            args.person or "Joseph_Lai", base_faces_dir=args.base_dir, model_dir=args.model_dir,
            n_components=cfg.train.n_components, device=device,
        )
        print(json.dumps({"models": paths}))
    elif args.enhanced:
        from face_detection_recognization_pca_tpu_torch.io.images import imread_gray
        from face_detection_recognization_pca_tpu_torch.models.enhanced import (
            save_enhanced,
            train_enhanced,
        )

        if not args.person:
            p.error("--enhanced needs --person")
        pdir = os.path.join(args.lock_dir or cfg.paths.lock_dir, args.person)
        # The crops the detection JSON lists, read gray.
        _, info = _load_person_crops(pdir, args.person)
        crops = []
        for rec in info:
            path = rec["image_path"]
            if not os.path.exists(path):
                path = os.path.join(pdir, os.path.basename(path.replace("\\", "/")))
            img = imread_gray(path)
            if img is not None:
                crops.append(img)
        model = train_enhanced(crops, [0] * len(crops), {args.person: 0}, device=device)
        out = os.path.join(pdir, "enhanced_model.pkl")
        save_enhanced(model, out)
        print(json.dumps({"model": out, "crops": len(crops)}))
    elif args.all:
        arts = train_all_persons(args.lock_dir, cfg, device=device)
        print(json.dumps({k: a.n_components for k, a in arts.items()}))
    elif args.person:
        art = train_single_person(args.person, args.lock_dir, cfg, device=device)
        print(json.dumps({"person": args.person, "n_components": art.n_components,
                          "n_faces": int(art.features.shape[0])}))
    else:
        p.error("train needs --person or --all")
    return 0


def _scan(p, args, cfg, device) -> int:
    from face_detection_recognization_pca_tpu_torch.pipeline import scan_app

    if args.dual:
        from face_detection_recognization_pca_tpu_torch.pipeline.v1_apps import scan_dual

        detector = None
        if args.template_detect:
            from face_detection_recognization_pca_tpu_torch.detect.ccoeff import (
                CcoeffTemplateDetector,
            )

            detector = CcoeffTemplateDetector.from_faces_dir(args.faces_dir, device=device)
        out = scan_dual(
            args.video, args.dual, output_dir=args.output or cfg.paths.output_dir, config=cfg,
            detector=detector, max_frames=args.max_frames, device=device,
        )
        print(json.dumps(out))
        return 0
    if args.tracked:
        from face_detection_recognization_pca_tpu_torch.pipeline.tracked_scan import (
            scan_video_tracked,
        )

        if not (args.video and args.person):
            p.error("--tracked needs --video and --person")
        results = scan_video_tracked(
            args.video, args.person, args.lock_dir, output_json=args.output, config=cfg,
            max_frames=args.max_frames, device=device,
        )
    elif args.enhanced:
        if not (args.video and args.person):
            p.error("--enhanced needs --video and --person")
        results = scan_app.scan_enhanced_video(
            args.video, args.person, args.lock_dir, args.output, cfg, args.max_frames,
            device=device,
        )
    elif args.haar_multi:
        results = scan_app.scan_haar_multimodel(
            args.video, args.lock_dir, args.output, cfg, args.max_frames, device=device
        )
    elif args.live and args.person:
        # --live --person = guided live mode (scripts/manual/
        # run_pipeline.py:242 passes these to scan-template-v2).
        results = scan_app.scan_live_guided(
            args.person, lock_dir=args.lock_dir, output_path=args.output, config=cfg,
            max_frames=args.max_frames, device=device,
        )
    elif args.live:
        results = scan_app.scan_multimodel(
            0, args.lock_dir, args.output, cfg, args.max_frames, device=device
        )
    elif args.multi and args.batched:
        results = scan_app.scan_multimodel_batched(
            args.video, args.lock_dir, args.output, cfg, args.max_frames,
            batch_frames=args.batch_frames, device=device,
        )
    elif args.multi:
        results = scan_app.scan_multimodel(
            args.video, args.lock_dir, args.output, cfg, args.max_frames, device=device
        )
    elif args.video and args.person:
        results = scan_app.scan_video_guided(
            args.video, args.person, args.lock_dir, args.output, cfg, args.max_frames,
            device=device,
        )
    else:
        p.error("scan needs --live, or --video with --person/--multi")
    print(json.dumps({"recognitions": len(results)}))
    return 0


def _gen_json(p, args, cfg) -> int:
    # Standalone detection-JSON backfill, reference
    # generate_detection_json.py:119-155: scan person dirs under the
    # lock root, skip dirs whose JSON already exists (unless --force),
    # write the 12-field schema with x=y=0 and 30 fps.
    from face_detection_recognization_pca_tpu_torch.io.detection_json import (
        generate_detection_json,
    )

    lock = args.lock_dir or cfg.paths.lock_dir
    if not os.path.isdir(lock):
        p.error(f"directory {lock} not found")
    persons = [args.person] if args.person else sorted(
        d for d in os.listdir(lock) if os.path.isdir(os.path.join(lock, d))
    )
    generated, skipped = [], []
    for name in persons:
        pdir = os.path.join(lock, name)
        jpath = os.path.join(pdir, f"{name}_faces_detection.json")
        if os.path.exists(jpath) and not args.force:
            skipped.append(jpath)
            continue
        det = generate_detection_json(pdir, name, output_path=jpath)
        generated.append({"path": jpath, "faces": det.total_faces_detected})
    print(json.dumps({"generated": generated, "skipped": skipped}))
    return 0


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    cfg = _load_config(args.config)
    # Each entry point resolves None to the CUDA device itself, so a
    # subcommand that computes nothing (gen-json) needs no card.
    device = args.device

    if args.cmd == "detect":
        return _detect(args, cfg, device)
    if args.cmd == "train":
        return _train(p, args, cfg, device)
    if args.cmd == "scan":
        return _scan(p, args, cfg, device)
    if args.cmd == "pipeline":
        from face_detection_recognization_pca_tpu_torch.pipeline.run_pipeline import run_pipeline

        out = run_pipeline(
            args.person, video_path=args.video, live=args.live, config=cfg,
            max_frames=args.max_frames, scan=not args.no_scan, device=device,
        )
        print(json.dumps(out))
        return 0
    if args.cmd == "gen-json":
        return _gen_json(p, args, cfg)
    if args.cmd == "eval":
        from face_detection_recognization_pca_tpu_torch.pipeline.eval_app import holdout_eval

        stats = holdout_eval(
            args.lock_dir, holdout_every=args.holdout_every, n_components=args.components,
            max_per_person=args.max_per_person, config=cfg, device=device,
        )
        print(json.dumps(stats))
        return 0
    if args.cmd == "bench":
        from face_detection_recognization_pca_tpu_torch import bench

        result = bench.headline(
            streams=args.streams, size=bench.SIZES[args.size], t_frames=args.frames, device=device
        )
        print(json.dumps(result))
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
