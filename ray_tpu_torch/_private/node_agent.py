"""Node agent: the per-host daemon of a multi-host cluster.

The analogue of the reference's raylet/NodeManager
(src/ray/raylet/node_manager.h:122, main.cc) reduced to what a GPU host
needs from a per-host runtime: register the host's resources with the
hub, fork worker processes on demand, serve shm-segment reads for
cross-node object fetches, and report child deaths. Scheduling stays
centralized in the hub (single-controller, like the GCS-direct
actor-scheduling mode, gcs_actor_scheduler.cc:54) — the agent is a thin
execution arm, so there is no raylet-side state to keep consistent.

Wire: one TCP connection to the hub (protocol.py REGISTER_NODE /
SPAWN_WORKER / WORKER_EXITED / OBJ_READ / OBJ_UNLINK / KILL).

Spawned workers connect straight to the hub themselves; the agent only
owns their lifetime (terminate on KILL/SIGTERM, reap on exit).

Port of ``ray_tpu/_private/node_agent.py``: the host's GPUs are the
pinned accelerator. Their count comes from ``RAY_TPU_TORCH_NUM_GPUS``
(default 0) and is registered as ``{"GPU": n}`` with ids ``0..n-1``,
positions in this agent's own ``CUDA_VISIBLE_DEVICES``, which its workers
inherit and ``worker_process._pin_gpus`` indexes. GPUs report no chip
coordinates, so SLICE placement stays inert, as on the head. The agent
never touches CUDA: it holds no context on the cards its workers use.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
from typing import Dict

from . import protocol as P
from .serialization import dumps_frame, loads_frame


class NodeAgent:
    def __init__(self):
        from .client import connect_hub

        self.hub_addr = os.environ["RAY_TPU_TORCH_HUB_ADDR"]
        self.node_id = os.environ["RAY_TPU_TORCH_NODE_ID"]
        self.session_dir = os.environ["RAY_TPU_TORCH_SESSION_DIR"]
        self.hostname = os.environ.get("RAY_TPU_TORCH_NODE_HOSTNAME") or socket.gethostname()
        self.ip = os.environ.get("RAY_TPU_TORCH_NODE_IP", "127.0.0.1")
        import tempfile

        self.spill_dir = os.environ.get("RAY_TPU_TORCH_SPILL_DIR") or os.path.join(
            tempfile.gettempdir(),
            "ray_tpu_torch_spill_" + os.path.basename(self.session_dir),
        )
        os.makedirs(os.path.join(self.session_dir, "objects"), exist_ok=True)
        self.children: Dict[str, subprocess.Popen] = {}
        # out-of-band object plane: this host's data-plane endpoint.
        # Peers resolve it through the hub directory and stream segment
        # bytes here directly — the hub relay (OBJ_READ) stays as the
        # fallback. TCP because cluster mode is TCP (remote peers must
        # be able to reach it); bound to this host's address.
        self.object_agent = None
        from .config import RAY_TPU_TORCH_CONFIG

        if RAY_TPU_TORCH_CONFIG.object_agent:
            from .object_agent import ObjectAgent

            try:
                self.object_agent = ObjectAgent(
                    os.path.join(self.session_dir, "objects"),
                    spill_dir=self.spill_dir,
                    host=os.environ.get("RAY_TPU_TORCH_NODE_IP", "127.0.0.1"),
                )
            except OSError:
                pass  # relay-only node
        # fault injection (chaos.py, "agent" scope): drop/delay/dup on
        # this agent's outbound messages — e.g.
        # drop:agent.node_heartbeat@1 is heartbeat suppression, the
        # cheap half of a partition (the hub's heartbeat-miss watchdog
        # must then declare this node dead). None = inert.
        from .chaos import engine_for

        self._chaos = engine_for("agent")
        self.conn = connect_hub(self.hub_addr)

        resources = {"CPU": float(os.environ.get("RAY_TPU_TORCH_NUM_CPUS", "1"))}
        ngpu = int(os.environ.get("RAY_TPU_TORCH_NUM_GPUS", "0"))
        if ngpu:
            resources["GPU"] = float(ngpu)
        resources["memory"] = float(
            os.environ.get("RAY_TPU_TORCH_MEMORY", 64 * 1024**3)
        )
        custom = os.environ.get("RAY_TPU_TORCH_CUSTOM_RESOURCES")
        if custom:
            resources.update({k: float(v) for k, v in json.loads(custom).items()})
        self._send(
            P.REGISTER_NODE,
            {
                "req_id": 0,
                "node_id": self.node_id,
                "hostname": self.hostname,
                "ip": self.ip,
                "session_dir": self.session_dir,
                "resources": resources,
                # GPU ids take the place of chip ids; no coordinates
                "tpu_chip_ids": list(range(ngpu)),
                "tpu_chip_coords": {},
                "max_workers": int(
                    os.environ.get("RAY_TPU_TORCH_MAX_WORKERS")
                    or max(4, int(resources["CPU"]))
                ),
                "store_cap": float(
                    os.environ.get("RAY_TPU_TORCH_OBJECT_STORE_MEMORY", 0)
                ),
                "object_endpoint": (
                    self.object_agent.endpoint if self.object_agent else ""
                ),
            },
        )

    def _send(self, msg_type: str, payload: dict) -> None:
        n = 1
        if self._chaos is not None:
            n = self._chaos.outbound_send(msg_type)  # 0 drop / 1 / 2 dup
            if n == 0:
                return
        blob = dumps_frame((msg_type, payload))
        for _ in range(n):
            self.conn.send_bytes(blob)

    # ------------------------------------------------------------------
    def run(self) -> None:
        import time

        signal.signal(signal.SIGTERM, lambda *a: self._shutdown())
        # same config knob the hub's head self-sampler reads, so both
        # sides of the cluster heartbeat at one cadence
        from .config import RAY_TPU_TORCH_CONFIG

        hb_period = float(RAY_TPU_TORCH_CONFIG.node_heartbeat_period_s)
        # the poll timeout bounds the heartbeat jitter: at the default
        # 2s period a 1s poll is fine, but a sub-second period (tests,
        # aggressive heartbeat-miss thresholds) must not be floored to
        # the 1s poll or the hub's miss watchdog sees phantom silence
        poll_t = min(1.0, hb_period) if hb_period > 0 else 1.0
        last_hb = 0.0
        try:
            while True:
                if self.conn.poll(poll_t):
                    # bounded burst drain (the hub reactor's shape): a
                    # spawn storm from the hub — now potentially fanned
                    # out by several reactor shards at once — lands as
                    # one wake + N handles instead of N one-second poll
                    # cycles. The budget keeps reaping/heartbeats live.
                    budget = 64
                    while True:
                        blob = self.conn.recv_bytes()
                        msg_type, payload = loads_frame(blob)
                        self._handle(msg_type, payload)
                        budget -= 1
                        if budget <= 0 or not self.conn.poll(0):
                            break
                self._reap()
                now = time.monotonic()
                if hb_period > 0 and now - last_hb >= hb_period:
                    last_hb = now
                    self._heartbeat()
        except (EOFError, OSError):
            pass  # hub gone: tear down
        finally:
            self._shutdown()

    def _heartbeat(self) -> None:
        """Report this host's vitals; the hub turns them into
        ray_tpu_node_* gauges (reference: raylet resource reports
        carried on heartbeats, node_manager.cc ReportResourceUsage)."""
        from .debug import proc_rss_bytes

        rss = proc_rss_bytes(os.getpid()) + sum(
            proc_rss_bytes(p.pid) for p in self.children.values()
        )
        try:
            load = os.getloadavg()[0]
        except OSError:
            load = 0.0
        self._send(
            P.NODE_HEARTBEAT,
            {
                "node_id": self.node_id,
                "rss_bytes": rss,
                "cpu_load_1m": load,
                "n_workers": len(self.children),
                "object_agent": (
                    self.object_agent.stats() if self.object_agent else None
                ),
            },
        )

    def _handle(self, msg_type: str, p) -> None:
        if msg_type == "batch":
            # hub reactor coalesces its per-peer sends (hub._send)
            for mt, pl in p:
                self._handle(mt, pl)
            return
        if msg_type == P.SPAWN_WORKER:
            env = dict(os.environ)
            env.update(p["env"])
            env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
            env["RAY_TPU_TORCH_NODE_ID"] = self.node_id
            env["RAY_TPU_TORCH_NODE_HOSTNAME"] = self.hostname
            env["RAY_TPU_TORCH_NODE_IP"] = self.ip
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.worker_process"],
                env=env,
            )
            self.children[p["worker_id"]] = proc
        elif msg_type == P.OBJ_READ:
            path = os.path.join(self.session_dir, "objects", p["name"])
            if not os.path.exists(path):
                path = os.path.join(self.spill_dir, p["name"])  # spilled
            try:
                total = None
                with open(path, "rb") as f:
                    if p.get("offset") is None:
                        data = f.read()
                    else:
                        total = os.fstat(f.fileno()).st_size
                        f.seek(p["offset"])
                        data = f.read(p.get("length"))
                self._send(P.OBJ_READ_REPLY,
                           {"fetch_id": p["fetch_id"], "data": data,
                            "total": total})
            except OSError as err:
                self._send(
                    P.OBJ_READ_REPLY,
                    {"fetch_id": p["fetch_id"], "data": None, "error": str(err)},
                )
        elif msg_type == P.OBJ_UNLINK:
            for path in (
                os.path.join(self.session_dir, "objects", p["name"]),
                os.path.join(self.spill_dir, p["name"]),
            ):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        elif msg_type == P.OBJ_SPILL:
            import shutil

            os.makedirs(self.spill_dir, exist_ok=True)
            try:
                # tmpfs -> disk crosses filesystems (os.replace => EXDEV)
                shutil.move(
                    os.path.join(self.session_dir, "objects", p["name"]),
                    os.path.join(self.spill_dir, p["name"]),
                )
            except OSError:
                pass
        elif msg_type == P.OBJ_RESTORE:
            import shutil

            try:
                shutil.move(
                    os.path.join(self.spill_dir, p["name"]),
                    os.path.join(self.session_dir, "objects", p["name"]),
                )
            except OSError:
                pass
        elif msg_type == P.KILL_WORKER:
            # hub-side execute timeout / hung-worker watchdog / chaos
            # worker faults. sig="stop" is chaos worker_hang (SIGSTOP:
            # stall, socket stays open); default is SIGKILL, not
            # terminate — a SIGSTOP'd or wedged worker queues SIGTERM
            # forever (the reap loop reports the exit)
            proc = self.children.get(p.get("worker_id", ""))
            if proc is not None:
                try:
                    if p.get("sig") == "stop":
                        proc.send_signal(signal.SIGSTOP)
                    else:
                        proc.kill()
                except Exception:
                    pass
        elif msg_type == P.KILL:
            raise EOFError  # unified teardown path

    def _reap(self) -> None:
        for wid, proc in list(self.children.items()):
            code = proc.poll()
            if code is not None:
                del self.children[wid]
                try:
                    self._send(P.WORKER_EXITED, {"worker_id": wid, "code": code})
                except (OSError, BrokenPipeError):
                    pass

    def _shutdown(self) -> None:
        if self.object_agent is not None:
            self.object_agent.close()
        for proc in self.children.values():
            try:
                proc.terminate()
            except Exception:
                pass
        for proc in self.children.values():
            try:
                proc.wait(timeout=2)
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass
        # the session dir holds RAM-backed object segments: leaking it
        # across repeated join/terminate cycles eats /dev/shm (the
        # Cluster harness also rmtree's from the parent side; harmless
        # double-delete)
        import shutil

        shutil.rmtree(self.session_dir, ignore_errors=True)
        os._exit(0)


def main() -> None:
    NodeAgent().run()


if __name__ == "__main__":
    main()
