"""Deployment layouts, one module a layout, found by the name a
configuration's `layout` gives (gen/deploy.py `layout`)."""
