"""The cluster controller: heartbeats, stragglers, re-mesh plans."""
