from repro_torch.data.pipeline import ZipfKVWorkload, zipf_keys  # noqa: F401
