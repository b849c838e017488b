"""AcceleratorManager ABC (reference:
python/ray/_private/accelerators/accelerator.py)."""

from __future__ import annotations

from typing import Dict, List, Optional


class AcceleratorManager:
    """Static-method interface, one subclass per accelerator family."""

    @staticmethod
    def get_resource_name() -> str:
        raise NotImplementedError

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        raise NotImplementedError

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        raise NotImplementedError

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        raise NotImplementedError

    @staticmethod
    def get_current_node_additional_resources() -> Dict[str, float]:
        return {}

    @staticmethod
    def validate_resource_request_quantity(quantity: float):
        return (True, None)

    @staticmethod
    def set_current_process_visible_accelerators(ids: List[str]) -> None:
        raise NotImplementedError
