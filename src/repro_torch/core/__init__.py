"""The Dagger fabric's dataplane in PyTorch (port of ``repro.core``)."""
