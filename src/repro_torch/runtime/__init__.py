from repro_torch.runtime.server import Server  # noqa: F401
