"""DENSE core: the generator stage and the distillation stage against
the client ensemble (Algorithm 1), for CNN clients (dense.py) and, at
LLM scale, for decoder-LM clients (dense_llm.py)."""
from repro_torch.core.dense import (DenseHistory, evaluate, make_dense_steps,
                                    make_distill_step, train_dense_server)
from repro_torch.core.ensemble import (Client, apply_group_masks,
                                       ensemble_logits, group_clients,
                                       grouped_ensemble_logits,
                                       grouped_teacher, stack_grouped)
from repro_torch.core.generator import (ImgGenerator, TokGenerator,
                                        img_generator, img_generator_init,
                                        tok_generator, tok_generator_init)
from repro_torch.core.losses import (bn_loss, ce_loss, distill_loss,
                                     div_loss, gen_loss, softmax_kl)

__all__ = ["Client", "DenseHistory", "ImgGenerator", "TokGenerator",
           "apply_group_masks", "bn_loss", "ce_loss", "distill_loss",
           "div_loss", "ensemble_logits", "evaluate", "gen_loss",
           "group_clients", "grouped_ensemble_logits", "grouped_teacher",
           "img_generator", "img_generator_init", "make_dense_steps",
           "make_distill_step", "softmax_kl", "stack_grouped",
           "tok_generator", "tok_generator_init", "train_dense_server"]
