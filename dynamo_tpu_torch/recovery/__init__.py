"""Self-healing serving: watchdog-driven drain and respawn, and live
migration.

``controller.py`` owns the policy ladder (trip → drain → migrate →
respawn); ``migration.py`` owns the wire plane that moves an in-flight
request's committed KV and generation state to a healthy peer and relays
its continued stream back (or hands it to a consumer that re-binds).
"""

from .controller import RecoveryConfig, RecoveryController
from .migration import (
    MigrationRejected,
    MigrationServer,
    MigrationSink,
    MigrationState,
    migrate_request,
    migration_class,
    migration_key,
    package_request,
)

__all__ = [
    "RecoveryConfig",
    "RecoveryController",
    "MigrationRejected",
    "MigrationServer",
    "MigrationSink",
    "MigrationState",
    "migrate_request",
    "migration_class",
    "migration_key",
    "package_request",
]
