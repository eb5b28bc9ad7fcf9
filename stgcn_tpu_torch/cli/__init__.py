"""Command-line interface of the port: ``python -m stgcn_tpu_torch.cli``."""

from stgcn_tpu_torch.cli.main import (  # noqa: F401
    build_trainer,
    config_from_args,
    get_parameters,
    main,
)
