"""Train-step builders and the TrainState of the port."""

from repro_torch.train.loop import (advance_iv, init_iv,  # noqa: F401
                                    iv_step_sizes, make_train_state,
                                    make_train_step)
