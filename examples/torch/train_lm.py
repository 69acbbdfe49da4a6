"""Train a reduced-config architecture end to end on the port (driver
demo): 60 checkpointed steps of the smoke config through
``repro_torch.launch.train``.

    PYTHONPATH=src python examples/torch/train_lm.py [arch]
    PYTHONPATH=src python examples/torch/train_lm.py olmoe-1b-7b --device cpu

Runs on the GPU unless given ``--device cpu``.  Checkpoints go to
``--ckpt-dir`` (rerun with the same directory to resume), by default a
temporary directory removed at the end.
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="olmoe-1b-7b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_")
    try:
        return train(["--arch", args.arch, "--smoke", "--steps",
                      str(args.steps), "--batch", "8", "--seq", "64",
                      "--ckpt-dir", ckpt_dir, "--device", args.device])
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
