from repro_torch.runtime.kvs import DeviceKVS, KVSState  # noqa: F401
