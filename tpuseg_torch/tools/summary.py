"""Model summary (counterpart of ``tpuseg/tools/summary.py``): the
parameter table the reference prints at train start, grouped by module
name prefix."""
from __future__ import annotations

from typing import Dict

from torch import nn


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def summarize(model: nn.Module, max_depth: int = 2) -> str:
    """A parameter table grouped to ``max_depth`` levels of module names."""
    groups: Dict[str, int] = {}
    for name, p in model.named_parameters():
        group = ".".join(name.split(".")[:-1][:max_depth]) or "(root)"
        groups[group] = groups.get(group, 0) + p.numel()
    total = sum(groups.values())
    width = max((len(g) for g in groups), default=10)
    lines = [f"{'module':<{width}}  params"]
    lines += [f"{g:<{width}}  {n:,}" for g, n in sorted(groups.items())]
    lines.append("-" * (width + 10))
    lines.append(f"{'TOTAL':<{width}}  {total:,}")
    return "\n".join(lines)


def print_summary(model: nn.Module, name: str = "model", max_depth: int = 2) -> int:
    total = param_count(model)
    print(f"[tpuseg_torch] {name}: {total:,} trainable parameters")
    print(summarize(model, max_depth))
    return total
