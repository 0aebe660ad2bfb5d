"""The port's template index (`config.TemplateIndex`) against the reference
package's `find_template`, its plain scan:

  * over named repositories (an exact id listed twice, exact ids holding
    glob characters, a glob listed before an exact id, `?` and classes,
    backslashes, ids only `*` matches, no `*`, the intermediate's
    parent-derived 1,001 templates) and 200 seeded random ones, the
    index and the port's `find_template` pick the template at the same
    position as the reference's;
  * the server's index follows its config: a second `load_config` that
    moves a resource from an exact template to a glob re-templates the
    existing resources and new ones from the second repository, and
    still bumps the config epoch.
"""

import asyncio
import random

import pytest

from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.server import config as jconfig
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.server import config as config_mod
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer


def _repo(module, globs):
    """A repository of `globs` in order, template i of capacity i (its
    position, which the lookups are compared by)."""
    repo = module.ResourceRepository()
    for i, glob in enumerate(globs):
        tpl = repo.resources.add(identifier_glob=glob, capacity=float(i))
        tpl.algorithm.kind = module.Algorithm.PROPORTIONAL_SHARE
        tpl.algorithm.lease_length = 60
        tpl.algorithm.refresh_interval = 5
    return repo


def _position(tpl):
    return None if tpl is None else int(tpl.capacity)


def _assert_same_positions(globs, ids):
    repo = _repo(pb, globs)
    ref = _repo(jpb, globs)
    index = config_mod.TemplateIndex(repo)
    for rid in [*ids, *globs]:
        want = _position(jconfig.find_template(ref, rid))
        assert _position(index.find(rid)) == want, (globs, rid)
        assert _position(config_mod.find_template(repo, rid)) == want, (
            globs, rid)


TREE = [f"res{i}" for i in range(1000)] + ["*"]

REPOSITORIES = {
    "exact_listed_twice": (
        ["res1", "res1", "*"], ["res1", "res2"]),
    "exact_id_with_glob_chars": (
        ["a?", "a*", "*"], ["a*", "ab", "a?", "b"]),
    "glob_before_exact": (
        ["res*", "res7", "*"], ["res7", "res8", "res", "other"]),
    "question_and_classes": (
        ["r?", "x[0-3]", "y[!a-c]", "z[", "*"],
        ["r1", "rr", "r", "x2", "x5", "x[0-3]", "yd", "ya", "y", "z[", "z"]),
    "backslash": (
        ["a\\b", "c\\*", "d\\?", "*"],
        ["a\\b", "ab", "c\\x", "c\\", "c*", "d\\?", "d\\x", "d?"]),
    "only_star_matches": (
        ["fair", "proportional*", "*"],
        ["zzz", "fair", "fairer", "proportional7", ""]),
    "no_star": (
        ["a", "b*", "c?"], ["a", "bb", "c", "cc", "d"]),
    "tree_parent_derived": (
        TREE, ["res1000", "res", "other", "*"]),
}


@pytest.mark.parametrize("name", sorted(REPOSITORIES))
def test_index_picks_the_scans_template(name):
    globs, ids = REPOSITORIES[name]
    _assert_same_positions(globs, ids)


ALPHABET = "ab1["


def _word(rng):
    return "".join(rng.choice("ab1") for _ in range(rng.randint(1, 3)))


def _glob(rng):
    """An exact word, or one with a `*`, `?`, class or backslash in it."""
    word = _word(rng)
    at = rng.randint(0, len(word))
    meta = rng.choice(["", "*", "?", "[ab]", "[!a]", "[a-b]", "\\", "["])
    return word[:at] + meta + word[at:]


def test_index_matches_the_scan_on_random_repositories():
    rng = random.Random(20251018)
    for _ in range(200):
        globs = [_glob(rng) for _ in range(rng.randint(1, 20))]
        if rng.random() < 0.8:
            globs.append("*")
        # Exact ids of the repository, its globs asked as ids (by
        # _assert_same_positions), and fresh words that may miss.
        ids = [rng.choice(globs) for _ in range(10)]
        ids += [_word(rng) for _ in range(20)]
        ids += ["".join(rng.choice(ALPHABET) for _ in range(4))
                for _ in range(5)]
        _assert_same_positions(globs, ids)


FIRST = ["res1", "res2", "res*", "*"]
# res1 leaves its exact template for the res* glob; res2 keeps one.
SECOND = ["res2", "res*", "*"]


def test_server_index_follows_its_config():
    async def body():
        server = CapacityServer("idx", TrivialElection(),
                                minimum_refresh_interval=0.0, device="cpu")
        assert await server.load_config(_repo(pb, FIRST)) == (0, 0)
        await asyncio.sleep(0)
        for rid in ("res1", "res2", "res9", "other"):
            server.get_or_create_resource(rid)
        assert {rid: _position(r.template)
                for rid, r in server.resources.items()} == {
            "res1": 0, "res2": 1, "res9": 2, "other": 3}
        epoch = server._config_epoch
        counts = await server.load_config(_repo(pb, SECOND))
        return server, epoch, counts

    server, epoch, counts = asyncio.run(body())
    assert server._config_epoch == epoch + 1
    # res2 by its exact id; res1, res9 and other by a glob.
    assert counts == (1, 3)
    ref = _repo(jpb, SECOND)
    for rid, res in server.resources.items():
        assert _position(res.template) == _position(
            jconfig.find_template(ref, rid)), rid
    assert _position(server.resources["res1"].template) == 1
    for rid, want in (("res7", 1), ("res2x", 1), ("zz", 2)):
        assert _position(server.get_or_create_resource(rid).template) == want
        assert want == _position(jconfig.find_template(ref, rid))
