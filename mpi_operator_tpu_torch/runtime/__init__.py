"""Kubernetes-shaped runtime machinery: object model, in-memory API server,
typed clients, informers, and rate-limited workqueue."""
