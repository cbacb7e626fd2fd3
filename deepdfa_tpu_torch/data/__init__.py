"""Host-side graph data: batching and synthetic request traffic."""
