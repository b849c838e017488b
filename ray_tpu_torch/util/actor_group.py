"""ActorGroup: homogeneous gang of actors addressed as one unit.

Parity: python/ray/util (ActorGroup used by train/workers utilities) —
create N actors of one class, broadcast method calls, gather results,
replace failed members.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class ActorGroup:
    def __init__(
        self,
        actor_cls,
        num_actors: int,
        *,
        actor_options: Optional[Dict[str, Any]] = None,
        init_args: tuple = (),
        init_kwargs: Optional[dict] = None,
    ):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        remote_cls = ray_tpu_torch.remote(actor_cls)
        if actor_options:
            remote_cls = remote_cls.options(**actor_options)
        self._cls = remote_cls
        self._init = (init_args, dict(init_kwargs or {}))
        self.actors: List[Any] = [
            remote_cls.remote(*init_args, **(init_kwargs or {}))
            for _ in range(num_actors)
        ]

    def __len__(self) -> int:
        return len(self.actors)

    def execute_async(self, method: str, *args, **kwargs) -> List[Any]:
        return [
            getattr(a, method).remote(*args, **kwargs) for a in self.actors
        ]

    def execute(self, method: str, *args, **kwargs) -> List[Any]:
        return self._ray.get(self.execute_async(method, *args, **kwargs))

    def execute_single(self, index: int, method: str, *args, **kwargs) -> Any:
        return self._ray.get(
            getattr(self.actors[index], method).remote(*args, **kwargs)
        )

    def restart_actor(self, index: int) -> None:
        """Replace one member (e.g. after ActorDiedError)."""
        try:
            self._ray.kill(self.actors[index])
        except Exception:
            pass
        args, kwargs = self._init
        self.actors[index] = self._cls.remote(*args, **kwargs)

    def shutdown(self) -> None:
        for a in self.actors:
            try:
                self._ray.kill(a)
            except Exception:
                pass
        self.actors = []
