"""IterPro's contribution in the port: detection (``detect``), fault
injection (``faults``), diagnosis (``induction``, ``icp``,
``recovery_table``) and repair (``recover`` via ``microcheckpoint`` and
``replay``), exact-or-abort."""
