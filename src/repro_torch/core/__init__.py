"""Channels, the over-the-air uplink, G(PO)MDP and the fedpg loops."""
