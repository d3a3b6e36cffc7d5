"""``python -m srt_tpu_torch``: the command-line renderer (:mod:`cli`)."""
from srt_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
