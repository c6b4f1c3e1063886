"""The comparison system of the paper's evaluation: the Ceph-like cluster
and mount on the storage plane's simulated network (the port's copy of the
reference's ``repro.baseline``).  See :mod:`repro_torch.baseline.cephlike`."""
