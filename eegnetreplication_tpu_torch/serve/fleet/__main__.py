"""``python -m eegnetreplication_tpu_torch.serve.fleet`` — the fleet endpoint."""

from eegnetreplication_tpu_torch.serve.fleet.service import main

if __name__ == "__main__":
    raise SystemExit(main())
