from repro_torch.models.cnn import (CNN, CNNSpec, KINDS, cnn_apply, cnn_init,
                                    cnn_logits)

__all__ = ["CNN", "CNNSpec", "KINDS", "cnn_apply", "cnn_init", "cnn_logits"]
