"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``); without a GPU that raises rather
    than quietly running on the CPU. The CPU is used only when the caller
    names it (``device="cpu"``), as the tests do.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shodh_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev


def add_device_args(parser, what: str) -> None:
    """``--device`` and ``--cpu`` on an entry point's argument parser."""
    parser.add_argument("--device", default=None,
                        help=f"torch device of {what} (default: the CUDA card; 'cpu')")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")


def device_arg(parser, args):
    """The device that ``add_device_args``' options name: ``None`` (the card)
    unless one is given. ``--cpu`` beside another ``--device`` is a usage
    error."""
    if args.cpu and args.device not in (None, "cpu"):
        parser.error("--cpu contradicts --device " + args.device)
    return "cpu" if args.cpu else args.device
