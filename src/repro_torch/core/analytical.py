"""The paper's analytical cost/performance model (§5.3, Table 6).

    FaaS(w) = t_F(w) + s/B_S3
              + R_F * f_F(w) * [ (3w-2) * (m/w/B_ch + L_ch) + C_F/w ]
    IaaS(w) = t_I(w) + s/min(B_S3, B_n)
              + R_I * f_I(w) * [ (2w-2) * (m/w/B_n + L_n) + C_I/w ]

(s = dataset MB, m = model MB, R = epochs to converge on one worker, f(w) =
convergence scaling factor, C = single-worker epoch compute seconds.)

Includes the Table 6 constants, a sampling-based epoch estimator (Kaoudi et
al. [54], 10% sample), and the Q1/Q2 what-if studies (faster FaaS-IaaS
link / GPU-FaaS pricing; hot data).

The cost arithmetic is plain Python floats in the JAX package's order of
operations, so every time and dollar equals the JAX package's bitwise.
Only :func:`estimate_epochs` touches tensors: it trains on the run's
device (the card unless the caller passes ``device="cpu"``).

The ``(s, m, R, C)`` constants are ONE derivation away from the simulator:
:meth:`CostInputs.from_workload` computes them from any study workload, so
the analytic curves and the discrete-event sweeps describe the same
workload by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.comm.codecs import make_codec
from repro_torch.core.comm.transports import (
    CHANNEL_SPECS, EBS_BANDWIDTH, EBS_LATENCY, VMParameterServer,
    transport_constants, xfer_seconds)
from repro_torch.core.runtimes import (
    _T_FAAS, _T_IAAS, _T_POD, B_NET, L_NET, LIFETIME, LIFETIME_MARGIN,
    POD_DCN_BANDWIDTH, POD_DCN_LATENCY, interp_startup,
)

# ------------------------------- Table 6 -------------------------------------
# Derived from the SAME Transport constants the simulator meters with
# (repro_torch.core.comm.transports.CHANNEL_SPECS and the runtimes' NIC
# tables): Table 6 is a *view*, not a second copy.
TABLE6 = {
    "t_F": dict(_T_FAAS),
    "t_I": dict(_T_IAAS),
    "B_S3": CHANNEL_SPECS["s3"].bandwidth, "B_EBS": EBS_BANDWIDTH,
    "B_n": {k: B_NET[k] for k in ("t2.medium", "c5.large")},
    "B_EC": {"cache.t3.medium": CHANNEL_SPECS["memcached"].bandwidth,
             "cache.m5.large": CHANNEL_SPECS["memcached_large"].bandwidth},
    "L_S3": CHANNEL_SPECS["s3"].latency, "L_EBS": EBS_LATENCY,
    "L_n": {k: L_NET[k] for k in ("t2.medium", "c5.large")},
    "L_EC": {"cache.t3.medium": CHANNEL_SPECS["memcached"].latency},
}


@dataclass
class CostInputs:
    """The analytic model's ``(s, m, R, C)`` constants for one workload."""
    s_bytes: float          # dataset size
    m_bytes: float          # model size
    R: float                # single-worker epochs to target loss
    C: float                # single-worker seconds per epoch
    f: callable = field(default=lambda w: 1.0)  # convergence scaling

    @classmethod
    def from_workload(cls, workload, ds_train, *, R: float | None = None,
                      algo=None, target_loss: float | None = None,
                      worker_flops: float | None = None, params=None,
                      f=None, device=None) -> "CostInputs":
        """Derive the constants from a study workload: ``s`` = the training
        partition's bytes, ``m`` = the fp32 update-vector bytes
        (:func:`repro_torch.core.workloads.update_vector_bytes`), ``C`` =
        dataset rows x ``flops_per_row`` over one worker's FLOP/s (default:
        the t2.medium CPU model), and ``R`` either given explicitly or
        measured with the sampling estimator [54] on ``device`` (needs
        ``algo`` + ``target_loss``)."""
        from repro_torch.core import cost as pricing
        from repro_torch.core.workloads import update_vector_bytes

        if worker_flops is None:
            worker_flops = pricing.VM_CPU_FLOPS
        if R is None:
            if algo is None or target_loss is None:
                raise ValueError("pass R= explicitly, or algo= and "
                                 "target_loss= for the sampling estimator")
            R = estimate_epochs(workload, algo, ds_train, target_loss,
                                device=device)
        kw = {} if f is None else {"f": f}
        return cls(s_bytes=float(ds_train.nbytes),
                   m_bytes=float(update_vector_bytes(workload, params)),
                   R=float(R),
                   C=ds_train.n * workload.flops_per_row / worker_flops,
                   **kw)


def wire_bytes(m_bytes: float, codec: str = "fp32") -> float:
    """Per-round wire bytes after a :mod:`repro_torch.core.comm.codecs`
    codec -- the same ``wire_floats`` the simulator meters ``comm_bytes``
    with."""
    c = make_codec(codec)
    if c.is_identity:
        return float(m_bytes)
    n = max(int(m_bytes) // 4, 1)
    return float(c.wire_floats(n) * 4)


def restart_seconds(platform: str, m_bytes: float = 0.0, *,
                    ckpt: object = None, channel: str = "s3",
                    workers: int = 1) -> float:
    """DERIVED worker-restart seconds (DESIGN.md §17): platform startup
    for one replacement worker plus the metered restore of the model's
    byte size through the checkpoint transport -- the same
    :func:`~repro_torch.core.comm.transports.xfer_seconds` /
    :meth:`~repro_torch.core.ckpt.CheckpointSpec.restore_seconds`
    arithmetic the simulator bills.  With no explicit transport the
    restore reads ``channel``'s constants (the engine's default store)."""
    from repro_torch.core.ckpt import ckpt_transport_constants, make_ckpt
    table = {"faas": _T_FAAS, "iaas": _T_IAAS, "pod": _T_POD}[platform]
    startup = interp_startup(table, 1)
    if m_bytes <= 0:
        return startup
    spec = make_ckpt(ckpt)
    ch = ckpt_transport_constants(spec.transport or channel)
    return startup + spec.restore_seconds(m_bytes, ch, workers)


def faas_time(wl: CostInputs, w: int, *, channel: str = "s3",
              codec: str = "fp32") -> float:
    """§5.3 FaaS(w), over any storage transport's Table 6 constants (the
    legacy ``"elasticache"`` alias maps to memcached) and any codec's wire
    ratio.  Runs longer than one Lambda lease add one checkpoint save +
    derived restart per elapsed lease."""
    spec = transport_constants(
        "memcached" if channel == "elasticache" else channel)
    b, lat = spec.bandwidth, spec.latency
    m = wire_bytes(wl.m_bytes, codec)
    t = interp_startup(TABLE6["t_F"], w) + wl.s_bytes / w / TABLE6["B_S3"]
    per_round = (3 * w - 2) * (m / w / b + lat) + wl.C / w
    train_span = wl.R * wl.f(w) * per_round
    n_rot = int(train_span // (LIFETIME - LIFETIME_MARGIN))
    if n_rot:       # ckpt save + re-invoke + restore, once per lease
        t += n_rot * (xfer_seconds(spec, wl.m_bytes)
                      + restart_seconds("faas", wl.m_bytes, channel=channel))
    return t + train_span


def iaas_time(wl: CostInputs, w: int, *, instance: str = "t2.medium") -> float:
    bn = TABLE6["B_n"][instance]
    ln = TABLE6["L_n"][instance]
    t = interp_startup(TABLE6["t_I"], w) + wl.s_bytes / w / min(TABLE6["B_S3"], bn)
    per_round = (2 * w - 2) * (wl.m_bytes / w / bn + ln) + wl.C / w
    return t + wl.R * wl.f(w) * per_round


def faas_cost(wl: CostInputs, w: int, t: float, gb: float = 3.0) -> float:
    from repro_torch.core import cost as pricing
    return pricing.lambda_cost(gb, t * w, w)


def iaas_cost(wl: CostInputs, w: int, t: float,
              instance: str = "t2.medium") -> float:
    from repro_torch.core import cost as pricing
    return pricing.ec2_cost(instance, t, w)


def pod_time(wl: CostInputs, w: int, *, chips_per_pod: int = 4,
             mfu: float | str = 0.4, codec: str = "fp32") -> float:
    """Pod(w): pod provisioning + S3 data load + ``R * f(w)`` rounds of a
    cross-pod DCN ring all-reduce and MFU-discounted compute on the
    SIMULATED pod chip (:data:`repro_torch.core.cost.PEAK_FLOPS`).
    ``mfu="measured"`` reads the committed roofline fraction
    (:mod:`repro_torch.core.calibration`)."""
    from repro_torch.core import cost as pricing
    from repro_torch.core.calibration import resolve_mfu

    mfu = resolve_mfu(mfu)
    m = wire_bytes(wl.m_bytes, codec)
    # wl.C is single-worker epoch seconds on the t2.medium CPU model
    # (CostInputs' calibration); rescale to one slice's discounted FLOP/s
    c_pod = wl.C * pricing.VM_CPU_FLOPS / (chips_per_pod * pricing.PEAK_FLOPS
                                           * mfu)
    t = interp_startup(_T_POD, w) + wl.s_bytes / w / TABLE6["B_S3"]
    per_round = (2 * w - 2) * (m / w / POD_DCN_BANDWIDTH + POD_DCN_LATENCY) \
        + c_pod / w
    return t + wl.R * wl.f(w) * per_round


def pod_cost(wl: CostInputs, w: int, t: float,
             chips_per_pod: int = 4) -> float:
    from repro_torch.core import cost as pricing
    return w * chips_per_pod * pricing.TPU_CHIP_HOURLY * t / 3600.0


# ----------------------------- epoch estimator --------------------------------

def estimate_epochs(model, algo, ds, target_loss: float, *, sample_frac=0.1,
                    max_epochs=100, seed=0, device=None) -> float:
    """Sampling-based estimator [54]: train on a 10% sample single-worker on
    ``device`` (``None`` = the card), count epochs to the target.  The
    initial parameters come from a CPU ``torch.Generator`` seeded with
    ``seed``, as :func:`repro_torch.core.engine.simulate` draws them."""
    from repro_torch.data.synthetic import Dataset
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    n = max(int(ds.n * sample_frac), 64)
    sub = Dataset(ds.name, ds.x[:n], ds.y[:n],
                  None if ds.idx is None else ds.idx[:n], ds.dim, ds.n_classes)
    params = model.init(torch.Generator().manual_seed(int(seed))).to(device)
    st = algo.init_worker(model, params, sub)
    for ep in range(1, max_epochs + 1):
        upd = algo.local_update(model, st, ep - 1)
        algo.apply_merged(model, st, upd, 1)
        if model.eval_loss(algo.eval_params(st), st.data) <= target_loss:
            return float(ep)
    return float(max_epochs)


# ------------------------------- what-ifs (§5.3.1) ----------------------------

def hybridps_time(wl: CostInputs, w: int, *,
                  bandwidth: float = VMParameterServer.base_bw,
                  update_unit: float = VMParameterServer.update_unit) -> float:
    """Hybrid VM-PS FaaS: 2 transfers + PS update per round."""
    t = interp_startup(TABLE6["t_F"], w) + wl.s_bytes / w / TABLE6["B_S3"]
    per_round = (2 * wl.m_bytes / bandwidth
                 + update_unit * wl.m_bytes * w + wl.C / w)
    return t + wl.R * wl.f(w) * per_round


def q1_fast_hybrid(wl: CostInputs, w: int) -> dict:
    """Q1: 10 GB/s FaaS<->VM link, no serialization bottleneck."""
    return {
        "hybrid_now": hybridps_time(wl, w),
        "hybrid_10GBps": hybridps_time(wl, w, bandwidth=10e9, update_unit=0.0),
        "faas_s3": faas_time(wl, w),
        "iaas": iaas_time(wl, w),
    }


def q2_hot_data(wl: CostInputs, w: int) -> dict:
    """Q2: data pre-resident on a VM; everyone reads from that VM."""
    bn = TABLE6["B_n"]["t2.medium"]
    iaas_hot = iaas_time(wl, w) - wl.s_bytes / w / TABLE6["B_S3"] \
        + wl.s_bytes / w / bn
    # FaaS must still pull from the VM at Lambda-to-EC2 speed (~40.5 MB/s)
    faas_hot = faas_time(wl, w) - wl.s_bytes / w / TABLE6["B_S3"] \
        + wl.s_bytes / w / VMParameterServer.base_bw
    return {"iaas_hot": iaas_hot, "faas_hot": faas_hot}
