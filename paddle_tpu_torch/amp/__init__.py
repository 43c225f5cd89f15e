from .auto_cast import (amp_guard, amp_state, auto_cast, black_list,  # noqa: F401
                        decorate, white_list)
from .grad_scaler import GradScaler  # noqa: F401
