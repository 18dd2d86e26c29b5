"""Streaming video serving (ingest -> RoI gate -> bucket -> encode ->
account). ``repro_torch.serving.server`` is the multi-stream session
server, ``repro_torch.serving.fleet`` the router over several of them."""

__all__ = ["FleetRouter", "FleetJob"]


def __getattr__(name: str):
    # lazy: the fleet imports the server, which imports this package's
    # other modules
    if name in __all__:
        from repro_torch.serving import fleet
        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
