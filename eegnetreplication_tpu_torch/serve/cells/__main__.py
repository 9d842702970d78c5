"""``python -m eegnetreplication_tpu_torch.serve.cells`` — the cell tier's endpoint."""

from eegnetreplication_tpu_torch.serve.cells.service import main

if __name__ == "__main__":
    raise SystemExit(main())
