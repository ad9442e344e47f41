"""The port's CLI: ``python -m mdx_torch --input x.dcm --output out``.

The flags, output and exit codes of the JAX package's ``main.py``: the
report on standard output and 0; ``ERROR: <reason>`` and 1 for what the
port refuses (no card, a codec it does not read); ``Error: <reason>`` and
1 for any other failure.  ``--batch`` runs a series or a directory on a
data axis of every visible card (as JAX's ``make_mesh()``; one launch of
ranks when there are several, in process on one), ``--resume`` skips
finished frames, ``--autotune`` sweeps the candidate grid, ``--window``
applies each file's stored VOI window.  The run is on the card;
``main(argv, device="cpu")`` runs it on the CPU (the tests do), and no
flag selects the device.

``.env`` in the working directory is loaded first (KEY=VALUE lines; the
environment wins).  ``--tv-mode``, else ``MDX_TV_MODE``, is read here once
and passed on as ``tv_mode`` (the autotune sweep's and GenAI mode's plans);
no op reads the environment.  ``--spatial`` QA's one large slice sharded
over the visible cards (``pipeline/spatial_runner.py``, with ``--window``
and ``--autotune``; its device part in one launch of ranks).  The run is
chosen in ``main.py``'s order: ``--spatial``, then ``--batch`` (which
ignores ``--genai`` and ``--plan-only``), then the one-image run, where
``--autotune`` wins over ``--genai``.  ``--genai`` is GenAI mode
(``--model``, ``--max-iters``; ``--plan-only`` prints the planner's plan
as JSON and executes nothing; ``--no-redact`` sets ``MDX_NO_REDACT``,
which sends the metadata to the model unfiltered): without a key the
planner's call fails and the run ends as main.py's does, the
deterministic report and a ``WARNING: GenAI failed (...)`` line.
``--no-show`` is accepted (the port never opens a window).
"""

from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger("mdx_torch")


def load_dotenv(path: str = ".env") -> None:
    """Minimal KEY=VALUE .env loader (no interpolation, # comments); the
    port's copy of ``mdx/serve/config.py``'s loader."""
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                os.environ.setdefault(k.strip(), v.strip().strip("'\""))
    except OSError:
        pass


def parse_args(argv=None) -> argparse.Namespace:
    default_model = os.environ.get("OPENAI_MODEL", "gpt-5-mini")
    parser = argparse.ArgumentParser(
        prog="python -m mdx_torch",
        description="Multi-Agent Medical Imaging Quality Assurance (DICOM "
                    "QA) on a CUDA card")
    parser.add_argument("--input", required=True,
                        help="Path to a DICOM file (or, with --batch, a "
                             "directory / multi-frame series)")
    parser.add_argument("--output", default="outputs",
                        help="Output directory for report and visuals "
                             "(default: outputs)")
    parser.add_argument("--no-show", action="store_true",
                        help="Accepted for main.py's flags; the port never "
                             "opens a window (it still saves the PNG)")
    parser.add_argument("--genai", action="store_true",
                        help="Enable GenAI agentic mode "
                             "(requires OPENAI_API_KEY)")
    parser.add_argument("--model", default=default_model,
                        help=f"LLM model for GenAI agents "
                             f"(default: {default_model})")
    parser.add_argument("--max-iters", type=int, default=4,
                        help="Max tuning iterations for the GenAI "
                             "TuningAgent (default: 4)")
    parser.add_argument("--plan-only", action="store_true",
                        help="GenAI generates the plan JSON but does not "
                             "execute enhancement")
    parser.add_argument("--no-redact", action="store_true",
                        help="Disable metadata redaction "
                             "(default: redact enabled)")
    parser.add_argument("--verbose", action="store_true",
                        help="Enable verbose / debug logging")
    parser.add_argument("--batch", action="store_true",
                        help="QA every frame of a series / every DICOM in "
                             "a directory, split over the visible cards")
    parser.add_argument("--resume", action="store_true",
                        help="With --batch, skip frames that already have a "
                             "completed run")
    parser.add_argument("--autotune", action="store_true",
                        help="LLM-free tuning: sweep a candidate parameter "
                             "grid on the card and apply the best plan")
    parser.add_argument("--window", action="store_true",
                        help="Apply each sample's stored DICOM VOI window "
                             "before QA (mixed-modality streams)")
    parser.add_argument("--tv-mode", choices=("ref", "fast"), default=None,
                        help="TV-denoise solve mode of the autotune sweep: "
                             "'ref' (default) or 'fast'; else MDX_TV_MODE")
    parser.add_argument("--spatial", action="store_true",
                        help="Shard one very large slice across the visible "
                             "cards (2-D row x col tiles when the extents "
                             "allow, else 1-D row blocks) and run the "
                             "sharded QA chain (with --autotune: the "
                             "candidate sweep)")
    return parser.parse_args(argv)


def run(args: argparse.Namespace, device="cuda") -> dict:
    """The run ``args`` asks for → its context (raises on failure)."""
    tv_mode = args.tv_mode or os.environ.get("MDX_TV_MODE") or None
    if args.spatial:
        from mdx_torch.pipeline.spatial_runner import run_pipeline_spatial

        return run_pipeline_spatial(
            input_path=args.input, output_dir=args.output,
            save_artifacts=True, window=args.window, autotune=args.autotune,
            device=device, tv_mode=tv_mode)
    if args.batch:
        from mdx_torch.pipeline.batch_runner import run_pipeline_batch

        return run_pipeline_batch(
            input_path=args.input, output_dir=args.output,
            save_artifacts=True, window=args.window, autotune=args.autotune,
            resume=args.resume, device=device, tv_mode=tv_mode)
    from mdx_torch.pipeline.runner import run_pipeline

    return run_pipeline(
        input_path=args.input, output_dir=args.output, genai=args.genai,
        model=args.model, max_iters=args.max_iters,
        plan_only=args.plan_only, save_artifacts=True,
        no_show=args.no_show, autotune=args.autotune, device=device,
        tv_mode=tv_mode)


def main(argv=None, device="cuda") -> int:
    load_dotenv()
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    if args.no_redact:
        os.environ["MDX_NO_REDACT"] = "1"

    try:
        context = run(args, device)
    except RuntimeError as exc:
        print(f"ERROR: {exc}")
        return 1
    except Exception as exc:
        print(f"Error: {exc}")
        logger.exception("Pipeline failed")
        return 1

    if context.get("plan_only") and context.get("plan"):
        print("\n=== GenAI Enhancement Plan (JSON) ===\n")
        print(context["plan"].model_dump_json(indent=2))
        if context.get("stop_reason"):
            print(f"\nStop reason: {context['stop_reason']}")
        return 0

    report_md = context.get("report_md", "")
    if report_md:
        print(report_md)
    if context.get("genai_fell_back"):
        print(f"\nWARNING: GenAI failed ({context.get('genai_error')}). "
              f"Used deterministic fallback.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
