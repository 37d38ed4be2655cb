"""IterPro's contribution in the port: detection (``detect``, fused into
the train step by ``fused_step``), fault
injection (``faults``), diagnosis (``induction``, ``icp``,
``recovery_table``) and repair (``recover`` via ``microcheckpoint``,
``replay`` and the XOR ``parity`` layer), exact-or-abort."""

from repro_torch.core.parity import ParityPlan, ParityStore, parity_plan_for

__all__ = ["ParityPlan", "ParityStore", "parity_plan_for"]
