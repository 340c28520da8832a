from repro_torch.fed import client, codecs, server, simulator, strategies  # noqa: F401
