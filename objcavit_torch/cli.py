"""The port's command line, with the reference main.py's flags.

    python -m objcavit_torch.cli -c params/<cfg>.yaml [--bf16] [--resume|--no-resume]  # train
    python -m objcavit_torch.cli -c params/<cfg>.yaml -v [--bf16] [--debug]   # validate
    python -m objcavit_torch.cli -c params/<cfg>.yaml -i [--bf16] [--debug]   # predict

Port of ``objcavit_tpu/cli.py``: the same flags (``-c -v -i --debug
--log_debug --bf16 --resume``), the reference's params files unchanged
(saved hparams.yaml files through the 'args:' unwrap) and the log format.
The dataset sections come from ``basicParams.yaml`` (misc_utils.py:41-48):
``basic_params_path``, else the one beside the config file, else the one in
``$OBJCAVIT_PARAMS_DIR``. It runs on the card unless ``device`` (or, when
the caller passes none, ``$OBJCAVIT_DEVICE``) says otherwise. Without
``-v`` or ``-i`` it trains (``Trainer.fit``).

Multi-process training: under the OBJCAVIT_COORDINATOR,
OBJCAVIT_NUM_PROCESSES and OBJCAVIT_PROCESS_ID env (which
``python -m objcavit_torch.parallel.launch -n N -- python -m
objcavit_torch.cli -c ...`` sets for each process) ``main`` joins the
process group before it builds anything (NCCL on the card, rank p on card
p % count; gloo on the CPU), logs ``process p/P`` and its device, trains
its rows of each global batch of ``basic.batch_size``, and leaves the
group when it returns (``parallel/distributed.py``).
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from objcavit_torch.config import check_and_validate_args, load_args
from objcavit_torch.parallel.distributed import (
    ENV_DEVICE,
    initialize_distributed,
    process_count,
    process_index,
    rank_device,
    shutdown_distributed,
)


def _resolve_basic_params(config_file: str, explicit: str | None) -> str:
    if explicit:
        return explicit
    candidates = [os.path.join(os.path.dirname(os.path.abspath(config_file)), "basicParams.yaml")]
    env_dir = os.environ.get("OBJCAVIT_PARAMS_DIR")
    if env_dir:
        candidates.append(os.path.join(env_dir, "basicParams.yaml"))
    for c in candidates:
        if os.path.exists(c):
            return c
    return candidates[0]  # check_and_validate_args skips an absent file


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="")
    parser.add_argument("-c", "--config_file", required=True,
                        help="Path to the config/params YAML file.")
    parser.add_argument("-v", "--validate", action="store_true",
                        help="Run validation with the latest (or configured) checkpoint; "
                             "one device, batch size 1.")
    parser.add_argument("-i", "--inference", action="store_true",
                        help="Run inference: per-image predictions, figures, metrics CSV.")
    parser.add_argument("--debug", action="store_true",
                        help="Debug mode: 1 batch / 1 epoch, synthetic-friendly.")
    parser.add_argument("--log_debug", action="store_true", help="DEBUG log level.")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (fp32 is the parity default).")
    parser.add_argument("--resume", action=argparse.BooleanOptionalAction, default=None,
                        help="Auto-resume: continue the newest run with a 'last' checkpoint, "
                             "restoring the full train state (model, optimizer, step). "
                             "--no-resume forces a new version dir even when the config "
                             "sets basic.auto_resume.")
    return parser.parse_args(argv)


def main(argv=None, basic_params_path: str | None = None, device=None):
    """Run the command line ``argv`` (``sys.argv[1:]`` when None); returns
    what ``Trainer.fit``, ``Trainer.validate`` or ``Trainer.predict`` returns.
    ``device`` None: ``$OBJCAVIT_DEVICE``, else the card."""
    device = device or os.environ.get(ENV_DEVICE, "cuda")
    joined = initialize_distributed(device=device)
    try:
        return _run(argv, basic_params_path, rank_device(device))
    finally:
        if joined:
            shutdown_distributed()


def _run(argv, basic_params_path: str | None, device: torch.device):
    cl = parse_args(argv)
    args = load_args(cl.config_file, debug=cl.debug, log_debug=cl.log_debug,
                     validate=cl.validate, inference=cl.inference)
    if args.get("validate") and args.get("inference"):
        raise SystemExit("-v and -i are exclusive")
    args.devices = 1 if cl.debug or cl.validate or cl.inference else None
    args.hardware.num_workers = 0 if cl.debug else args.hardware.num_workers
    args = check_and_validate_args(
        args, basic_params_path=_resolve_basic_params(cl.config_file, basic_params_path))

    logging.basicConfig(level=logging.DEBUG if args.get("log_debug") else logging.INFO,
                        force=True, format="[%(levelname)s][%(name)s] %(message)s")
    logging.info("Starting (model=%s dataset=%s name=%s)",
                 args.model.name, args.basic.dataset, args.basic.name)
    logging.info("process %d/%d on %s", process_index(), process_count(), device)

    from objcavit_torch.training.loop import Trainer

    trainer = Trainer(args, dtype=torch.bfloat16 if cl.bf16 else torch.float32, device=device)
    if args.get("validate"):
        logging.info("==== RUNNING VALIDATION ====")
        return trainer.validate()
    if args.get("inference"):
        logging.info("==== RUNNING INFERENCE ====")
        return trainer.predict()
    return trainer.fit(resume=cl.resume)


if __name__ == "__main__":
    main()
