"""Model-sharded serving across ranks: logical-axis rules and placement
(``sharding``) and the exact collectives (``collectives``)."""
