"""Static loader registry (the reference's DataLoaderFactory)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def get_data_loader(configs: dict, data_dirpath: Path, mode: Optional[str]):
    name = configs["data_loader"]["data_loader_name"]
    if name.startswith("NerfLlff"):
        from simplenerf_torch.data.llff import NerfLlffDataLoader

        return NerfLlffDataLoader(configs, data_dirpath, mode)
    if name.startswith("RealEstate"):
        from simplenerf_torch.data.realestate import RealEstateDataLoader

        return RealEstateDataLoader(configs, data_dirpath, mode)
    raise ValueError(f"Unknown data loader: {name}")
