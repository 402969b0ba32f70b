"""The paper's own experimental setting (Section 3.1) as a config object.

The port's own copy of ``repro/configs/paper_cifar.py``: every field and
default is the same, so one config value drives both packages
(tests/test_torch_round.py checks the fields agree). Knobs that select a
path the port does not have yet are kept; the entry points that read
them raise ``NotImplementedError`` when such a path is asked for.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class DenseExperimentConfig:
    # federation (paper defaults, §3.1.4)
    n_clients: int = 5
    alpha: float = 0.5              # Dirichlet concentration
    local_epochs: int = 200
    local_lr: float = 0.01
    local_momentum: float = 0.9
    batch_size: int = 128
    use_ldam: bool = False

    # data (procedural stand-in for CIFAR10)
    num_classes: int = 10
    image_size: int = 32
    in_ch: int = 3
    train_per_class: int = 512
    test_per_class: int = 128

    # client model zoo ("resnet18" homogeneous by default; Table 2 uses the
    # heterogeneous list)
    client_kinds: tuple = ("resnet18",) * 5
    global_kind: str = "resnet18"
    width: float = 1.0

    # DENSE server (Algorithm 1)
    nz: int = 100                   # generator latent dim
    g_lr: float = 1e-3              # Adam, eta_G
    s_lr: float = 0.01              # SGD, eta_S
    s_momentum: float = 0.9
    t_g: int = 30                   # generator inner steps per epoch
    epochs: int = 200               # T (distillation epochs)
    synth_batch: int = 128
    lambda_bn: float = 1.0          # lambda_1
    lambda_div: float = 0.5         # lambda_2
    comm_rounds: int = 1            # one-shot; >1 = §3.3.4 extension
    s_steps: int = 1                # student steps per epoch. 1 = Algorithm 1
                                    # verbatim; >1 draws fresh noise per step

    # Execution-mode knobs. None defers to the execution-policy profile
    # of the device (configs/backend.py); a set knob pins the mode.
    backend: str | None = None
    loop_mode: str | None = None    # epoch driver: "python" (cpu
                                    # profile) or "fused" (cuda)
    loop_chunk: int = 8
    client_loop_mode: str | None = None  # LocalUpdate driver: "grouped"
                                    # (the default) or "python"
    ensemble_shard_mode: str | None = None
    distill_kl_mode: str | None = None  # "ref" (materialized softmax +
                                    # autograd) or "fused" (the K1 kernel
                                    # pair, kernels/distill_kl.py)
    kernel_blocks: tuple = ()

    # federation-scale knobs
    plan_bucketing: str | None = None
    stack_chunk: int | None = None
    fedavg_mode: str | None = None
    fedavg_branch: int | None = None
    teacher_chunk: int | None = None

    # fault injection
    fault_plan: tuple = ()
    dropout_frac: float = 0.0
    fault_seed: int = 0

    # upload admission
    upload_policy: str = "quarantine"
    quorum: float = 0.5
    norm_screen: float = 0.0
    cos_screen: float | None = None

    # stage-2 self-healing
    nan_policy: str = "raise"       # non-finite server loss: "raise"
    checkpoint_every: int = 0
    checkpoint_path: str = ""
    seed: int = 0


CONFIG = DenseExperimentConfig()


def smoke() -> DenseExperimentConfig:
    """CPU-sized setting used by tests (relative claims only)."""
    return DenseExperimentConfig(
        n_clients=3, local_epochs=8, batch_size=64, train_per_class=96,
        test_per_class=32, image_size=16,
        client_kinds=("cnn1", "cnn1", "cnn1"), global_kind="cnn1",
        width=0.5, t_g=5, epochs=20, synth_batch=64, nz=32)
