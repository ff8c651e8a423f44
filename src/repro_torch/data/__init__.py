from repro_torch.data.synthetic import SyntheticTokens  # noqa: F401
