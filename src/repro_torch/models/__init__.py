from repro_torch.models.cnn import (CNN, CNNSpec, KINDS, client_views,
                                    cnn_apply, cnn_init, cnn_logits,
                                    cnn_stack_apply_grouped,
                                    cnn_stack_train_grouped, cnn_view,
                                    is_conv_stack, is_groupable,
                                    stack_models)

__all__ = ["CNN", "CNNSpec", "KINDS", "client_views", "cnn_apply",
           "cnn_init", "cnn_logits", "cnn_stack_apply_grouped",
           "cnn_stack_train_grouped", "cnn_view", "is_conv_stack",
           "is_groupable", "stack_models"]
