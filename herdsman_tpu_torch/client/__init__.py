from herdsman_tpu_torch.client.herd_client import HerdClient  # noqa: F401
