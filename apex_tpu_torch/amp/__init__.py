"""apex_tpu_torch.amp — mixed precision with the O0, O2 and O3 opt levels
(``apex_tpu/amp``). O1 and O4 are not ported yet; of O4's ``fp8`` module
the codec is."""

from apex_tpu_torch.amp.frontend import (  # noqa: F401
    AmpModel,
    initialize,
    load_state_dict,
    make_train_step,
    state_dict,
)
from apex_tpu_torch.amp.properties import Properties, opt_levels  # noqa: F401
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScaler, ScalerState, init_state)
from apex_tpu_torch.amp import fp8, scaler  # noqa: F401
