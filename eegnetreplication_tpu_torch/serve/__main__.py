"""``python -m eegnetreplication_tpu_torch.serve`` — the serving entry point."""

from eegnetreplication_tpu_torch.serve.service import main

if __name__ == "__main__":
    raise SystemExit(main())
