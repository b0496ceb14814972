from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: F401
                                     clip_by_global_norm, lr_schedule)
from repro_torch.optim.compress import (int8_ef_compress,  # noqa: F401
                                        int8_ef_decompress, pod_sync_step)
