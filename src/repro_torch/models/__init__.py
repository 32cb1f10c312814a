from repro_torch.models.api import Model, build_model, param_bytes, param_count  # noqa: F401
from repro_torch.models.tensors import TensorRecord, spec_records, tensor_records  # noqa: F401
