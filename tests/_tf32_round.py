"""The quickstart round (``repro_torch.launch.quickstart``) on the card,
cut to a few server epochs, under deterministic algorithms, for
tests/test_torch_cuda.py:

    python tests/_tf32_round.py entry|chip_smoke OUT

``entry`` sets the run up as the entry point does (``parse_device``,
which turns TF32 off); ``chip_smoke`` sets float32 with
``chip_smoke.full_float32`` instead and resolves the device itself. The
uploads, the FedAvg model, the student, the generator and the losses go
to OUT (``torch.save``)."""
import dataclasses
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from repro_torch.configs import resolve_device  # noqa: E402
from repro_torch.core import train_dense_server  # noqa: E402
from repro_torch.data import make_classification_data  # noqa: E402
from repro_torch.fl import build_federation, fedavg  # noqa: E402
from repro_torch.launch import quickstart as Q  # noqa: E402


def main(mode: str, out: str) -> None:
    if mode == "entry":
        dev = Q.parse_device(["--device", "cuda"], Q.__doc__)
    else:
        import chip_smoke
        chip_smoke.full_float32(torch)
        dev = resolve_device("cuda")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    scfg = dataclasses.replace(Q.config(), epochs=4)
    data = make_classification_data(
        0, num_classes=scfg.num_classes, size=scfg.image_size,
        ch=scfg.in_ch, train_per_class=scfg.train_per_class,
        test_per_class=scfg.test_per_class)
    clients, _ = build_federation(scfg, data, device=dev)
    avg = fedavg(clients)
    stu, gen, hist = train_dense_server(clients, scfg, device=dev,
                                        **Q.server_generators(dev))
    torch.save({"tensors": [v.detach().cpu() for m in
                            [*(c.model for c in clients), avg, stu, gen]
                            for v in m.state_dict().values()],
                "losses": [hist.gen_loss, hist.dis_loss, hist.gen_parts],
                "loop": hist.loop}, out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
