"""Resource configuration: YAML <-> ResourceRepository, validation, template
matching.

Mirrors the reference behavior (capability parity, not code):
  - validation rules: reference go/server/doorman/server.go:384-434
    (every glob well-formed; any present algorithm needs lease_length >=
    refresh_interval >= 1s; an entry for "*" with an algorithm must exist and
    be last)
  - template matching: server.go:626-649 (exact identifier match first, then
    first glob match in repository order)
  - YAML form: reference doc/configuration.md + the proto JSON naming
    (snake_case field names, algorithm kind as enum name string).
"""

from __future__ import annotations

import fnmatch
from typing import Optional

import yaml
from google.protobuf import json_format

from doorman_tpu_torch.proto import doorman_pb2 as pb


class ConfigError(ValueError):
    """Raised for an invalid ResourceRepository or config document."""


def parse_yaml_config(text: str) -> pb.ResourceRepository:
    """Parse a YAML (or JSON) document into a validated ResourceRepository.

    Accepts snake_case field names (matching the proto) as well as
    lowerCamelCase (proto-JSON default).
    """
    try:
        doc = yaml.safe_load(text)
    except yaml.YAMLError as e:
        raise ConfigError(f"malformed YAML: {e}") from e
    if doc is None:
        raise ConfigError("empty config document")
    if not isinstance(doc, dict):
        raise ConfigError("config root must be a mapping")
    repo = pb.ResourceRepository()
    try:
        json_format.ParseDict(doc, repo)
    except json_format.ParseError as e:
        raise ConfigError(f"bad config structure: {e}") from e
    validate_repository(repo)
    return repo


def repository_to_yaml(repo: pb.ResourceRepository) -> str:
    doc = json_format.MessageToDict(repo, preserving_proto_field_name=True)
    return yaml.safe_dump(doc, sort_keys=False)


def _glob_well_formed(glob: str) -> bool:
    # fnmatch never errors, so reject by hand the patterns Go's filepath.Match
    # calls ErrBadPattern: an unterminated character class, or a trailing
    # escape. Inside a class, a ']' directly after '[' (or '[!'/'[^') is a
    # literal member, and any further '[' is literal too.
    i, n = 0, len(glob)
    while i < n:
        ch = glob[i]
        if ch == "\\":
            if i + 1 >= n:
                return False
            i += 2
        elif ch == "[":
            j = i + 1
            if j < n and glob[j] in "!^":
                j += 1
            if j < n and glob[j] == "]":  # literal ']' as first member
                j += 1
            while j < n and glob[j] != "]":
                j += 2 if glob[j] == "\\" else 1
            if j >= n:
                return False
            i = j + 1
        else:
            i += 1
    return True


def validate_algorithm(algo: pb.Algorithm) -> None:
    if algo.refresh_interval < 1:
        raise ConfigError("invalid refresh interval, must be at least 1 second")
    if algo.lease_length < 1:
        raise ConfigError("invalid lease length, must be at least 1 second")
    if algo.lease_length < algo.refresh_interval:
        raise ConfigError("lease length must be larger than the refresh interval")
    # A `variant` parameter must name a known refinement of its wire
    # kind (algorithms.scalar.VARIANT_FACTORIES): a typo would silently
    # select the base lane, and — because algo_kind_for feeds the
    # solver's config mirror — flip the device lane set on a later fix,
    # so fail the config epoch loudly instead.
    from doorman_tpu_torch.algorithms.scalar import VARIANT_FACTORIES, get_parameter

    variant = get_parameter(algo, "variant")
    if variant is not None and (algo.kind, variant) not in VARIANT_FACTORIES:
        known = sorted(
            v for (k, v) in VARIANT_FACTORIES if k == algo.kind
        )
        raise ConfigError(
            f"unknown variant {variant!r} for algorithm "
            f"{pb.Algorithm.Kind.Name(algo.kind)}"
            + (f" (known: {', '.join(known)})" if known else
               " (this kind has no variants)")
        )


def validate_repository(repo: pb.ResourceRepository) -> None:
    """Validate a ResourceRepository; raises ConfigError when invalid."""
    groups = set()
    for grp in repo.groups:
        if not grp.name:
            raise ConfigError("capacity group without a name")
        if grp.name in groups:
            raise ConfigError(f"duplicate capacity group {grp.name!r}")
        if grp.capacity < 0:
            raise ConfigError(
                f"capacity group {grp.name!r} has negative capacity"
            )
        groups.add(grp.name)
    star_found = False
    for i, tpl in enumerate(repo.resources):
        glob = tpl.identifier_glob
        if not _glob_well_formed(glob):
            raise ConfigError(f"malformed glob: {glob!r}")
        # proto3 has no algorithm-presence bit on a message field beyond
        # being unset-equals-default; treat an all-default Algorithm on a
        # non-star template as "absent" only if it was never set.
        has_algo = tpl.HasField("algorithm")
        if has_algo:
            validate_algorithm(tpl.algorithm)
        if tpl.HasField("capacity_group"):
            if tpl.capacity_group not in groups:
                raise ConfigError(
                    f"template {glob!r} references undefined capacity "
                    f"group {tpl.capacity_group!r}"
                )
            if (
                not has_algo
                or tpl.algorithm.kind != pb.Algorithm.PRIORITY_BANDS
            ):
                raise ConfigError(
                    f"template {glob!r}: capacity_group requires the "
                    "PRIORITY_BANDS algorithm (groups are enforced by "
                    "the batched priority solve)"
                )
        if glob == "*":
            if not has_algo:
                raise ConfigError('the entry for "*" must specify an algorithm')
            if i + 1 != len(repo.resources):
                raise ConfigError('the entry for "*" must be the last one')
            star_found = True
    if not star_found:
        raise ConfigError('the resource repository must contain an entry for "*"')


def find_template(
    repo: pb.ResourceRepository, resource_id: str
) -> Optional[pb.ResourceTemplate]:
    """Find the template for a resource id: exact match first, then first
    glob match in repository order. Returns None only for an (invalid)
    repository without a "*" entry."""
    for tpl in repo.resources:
        if tpl.identifier_glob == resource_id:
            return tpl
    for tpl in repo.resources:
        if fnmatch.fnmatchcase(resource_id, tpl.identifier_glob):
            return tpl
    return None


def validate_get_capacity_request(req: pb.GetCapacityRequest) -> Optional[str]:
    """Returns an error string for an invalid request, else None
    (mirrors server.go:357-381)."""
    if not req.client_id:
        return "client_id cannot be empty"
    if _has_control_chars(req.client_id):
        return "client_id cannot contain control characters"
    for r in req.resource:
        if not r.resource_id:
            return "resource_id cannot be empty"
        if _has_control_chars(r.resource_id):
            return "resource_id cannot contain control characters"
        if r.wants < 0:
            return "capacity must be positive"
    return None


def _has_control_chars(s: str) -> bool:
    # Control characters in ids could forge the server's internal band
    # sub-lease keys (server._BAND_SEP) or break C-string interning in
    # the native store engine.
    return any(c < " " for c in s)


def validate_release_capacity_request(
    req: pb.ReleaseCapacityRequest,
) -> Optional[str]:
    if not req.client_id:
        return "client_id cannot be empty"
    if _has_control_chars(req.client_id):
        return "client_id cannot contain control characters"
    return None


def validate_get_server_capacity_request(
    req: pb.GetServerCapacityRequest,
) -> Optional[str]:
    """Validation for the intermediate-server RPC (mirrors the subclient
    checks exercised by reference server_test.go:483-553)."""
    if not req.server_id:
        return "server_id cannot be empty"
    if _has_control_chars(req.server_id):
        return "server_id cannot contain control characters"
    for r in req.resource:
        if not r.resource_id:
            return "resource_id cannot be empty"
        if _has_control_chars(r.resource_id):
            return "resource_id cannot contain control characters"
        for band in r.wants:
            if band.wants < 0:
                return "capacity must be positive"
            if band.num_clients < 1:
                return "num_clients must be positive"
    return None
