"""Operator CLI entry points (reference: app/scripts/*): scanner daemon,
queue worker, embedding backfill, tech-token backfill."""
