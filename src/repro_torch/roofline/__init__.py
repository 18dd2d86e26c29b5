"""Roofline terms on the H100 for the serving control plane's cost model
(the port's counterpart of src/repro/roofline/): the card's peaks
(``report.HW``) and an analytic count of one encode flush's FLOPs and
bytes (``cost.encode_cost``)."""
