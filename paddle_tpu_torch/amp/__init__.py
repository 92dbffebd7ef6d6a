from paddle_tpu_torch.amp.auto_cast import (BLACK_LIST, WHITE_LIST, amp_guard,
                                           amp_state, auto_cast, black_list,
                                           maybe_cast_inputs, white_list)

__all__ = ["auto_cast", "amp_guard", "white_list", "black_list",
           "amp_state", "maybe_cast_inputs", "WHITE_LIST", "BLACK_LIST"]
