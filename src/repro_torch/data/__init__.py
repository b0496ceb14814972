from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLMData, ZipfKVWorkload, zipf_keys)
