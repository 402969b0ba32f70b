from repro_torch.fl.baselines import (fed_adi, fed_dafl, fed_df,
                                      make_distill_step)
from repro_torch.fl.client import (local_update, local_update_bucketed,
                                   local_update_grouped,
                                   make_grouped_local_update, make_local_step)
from repro_torch.fl.faults import (FAULT_KINDS, Fault, apply_upload_faults,
                                   build_fault_plan, corrupt_params)
from repro_torch.fl.fedavg import fedavg, fedavg_stacked
from repro_torch.fl.federation import (ClientList, build_grouped_federation,
                                       client_specs, group_specs,
                                       train_clients_grouped)
from repro_torch.fl.multiround import dense_multi_round
from repro_torch.fl.protocol import (CommLedger, QuorumError, UploadError,
                                     admit_uploads, build_federation,
                                     direction_outliers, norm_outliers,
                                     param_bytes, upload_boundary,
                                     validate_upload)
from repro_torch.fl.sharding import (CLIENT_AXIS, group_shardable,
                                     put_grouped, put_stacked, resolve_mesh,
                                     stack_specs)

__all__ = ["CLIENT_AXIS", "FAULT_KINDS", "Fault", "QuorumError", "UploadError",
           "admit_uploads", "apply_upload_faults", "build_fault_plan",
           "corrupt_params", "direction_outliers", "norm_outliers",
           "validate_upload", "ClientList", "CommLedger", "build_federation",
           "build_grouped_federation", "client_specs", "dense_multi_round",
           "fed_adi", "fed_dafl", "fed_df", "fedavg", "fedavg_stacked",
           "group_specs", "local_update", "local_update_bucketed",
           "local_update_grouped",
           "make_distill_step", "make_grouped_local_update",
           "make_local_step", "param_bytes", "put_grouped", "put_stacked",
           "resolve_mesh", "stack_specs", "train_clients_grouped",
           "group_shardable", "upload_boundary"]
