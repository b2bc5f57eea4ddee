"""Command-line entry points of the port: ``train``, ``adapt`` and
``predict``, the counterparts of the repository's ``main.py``, ``adapt.py``
and ``predict.py``, with the same config grammar over ``configs/``:

    python -m multimodal_tta_tpu_torch.cli.train task=hecktor21 dataset=hecktor21 model=unet ...

Each module's ``main(argv=None, device="cuda")`` runs on the GPU and raises
without one; ``device="cpu"`` runs it on the CPU, as the tests do. A run
changes the working directory to its run directory
(``hydra.job.chdir: true`` in ``configs/config.yaml``).
"""

import os

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                          "configs")
