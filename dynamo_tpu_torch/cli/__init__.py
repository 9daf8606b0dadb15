"""The serve CLI (``python3 -m dynamo_tpu_torch.cli.run``)."""
