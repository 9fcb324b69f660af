"""The port's jobspec parser (nomad_tpu_torch.jobspec) against nomad_tpu's.

Every HCL text of tests/test_jobspec.py, specs written after the
reference fixtures that file reads (absent from this repo), ``cli
init``'s example and the three job files of chip_smoke.py's agent phase
parse in both packages to the same job, compared through each package's
``api.codec.to_dict``, that ``Job.validate`` accepts or refuses alike. A
bad spec raises an error of the same class name
with the same message in both. Durations parse to the same seconds.
"""

import pytest

from nomad_tpu import jobspec as jjobspec
from nomad_tpu.api.codec import to_dict as jax_to_dict
from nomad_tpu.cli import EXAMPLE_JOB as JAX_EXAMPLE_JOB
from nomad_tpu_torch import jobspec as pjobspec
from nomad_tpu_torch.api.codec import to_dict as port_to_dict
from nomad_tpu_torch.cli import EXAMPLE_JOB

import chip_smoke

WEB_APP = '''
job "web-app" {
    datacenters = ["dc1"]
    group "web" {
        count = 3
        task "server" {
            driver = "exec"
            config { command = "/bin/sleep" args = "60" }
            resources { cpu = 100 memory = 64 }
        }
    }
}
'''

# After the reference's test-fixtures/basic.hcl: meta, a job constraint,
# an update block, a standalone task and a group with restart, meta,
# constraints and a task with a network.
BASIC = '''
job "binstore-storagelocker" {
    region = "global"
    type = "service"
    priority = 50
    all_at_once = true
    datacenters = ["us2", "eu1"]

    meta {
        foo = "bar"
    }

    constraint {
        attribute = "kernel.os"
        value = "windows"
    }

    update {
        stagger = "60s"
        max_parallel = 2
    }

    task "outside" {
        driver = "java"
        config {
            jar = "s3://my-cool-store/foo.jar"
        }
        meta {
            my-cool-key = "foobar"
        }
    }

    group "binsl" {
        count = 5
        restart {
            attempts = 5
            interval = "10m"
            delay = "15s"
        }
        meta {
            elb_mode = "tcp"
            elb_interval = 10
            elb_checks = 3
        }
        task "binstore" {
            driver = "docker"
            config {
                image = "hashicorp/binstore"
            }
            resources {
                cpu = 500
                memory = 128
                network {
                    mbits = "100"
                    reserved_ports = [1, 2, 3]
                    dynamic_ports = ["http", "https", "admin"]
                }
            }
        }
        task "storagelocker" {
            driver = "java"
            config {
                image = "hashicorp/storagelocker"
            }
            resources {
                cpu = 500
                memory = 128
                iops = 30
            }
            constraint {
                attribute = "kernel.arch"
                value = "amd64"
            }
        }
        constraint {
            attribute = "kernel.os"
            value = "linux"
        }
    }
}
'''

DEFAULT_JOB = 'job "foo" {}\n'
SPECIFY_JOB = 'job "job1" {\n    name = "My Job"\n}\n'
VERSION_CONSTRAINT = '''
job "foo" {
    constraint {
        attribute = "$attr.kernel.version"
        version = "~> 3.2"
    }
}
'''
REGEXP_CONSTRAINT = '''
job "foo" {
    constraint {
        attribute = "$attr.kernel.version"
        regexp = "[0-9.]+"
    }
}
'''
DISTINCT_HOSTS = '''
job "foo" {
    constraint {
        distinct_hosts = "true"
    }
}
'''
MERGED_META = '''
job "m" {
    meta { a = "1" }
    meta { b = 2 }
    group "g" {
        task "t" { driver = "exec" }
    }
}
'''


def _port_block(body, ports):
    return f'''
job "foo" {{
    task "bar" {{
        driver = "docker"
        resources {{
            {body}
            network {{
                mbits = "100"
                dynamic_ports = [{ports}]
            }}
        }}
    }}
}}
'''


BAD_PORTS = _port_block("", '"this_is_aport", "this#is$not-a!port"')
OVERLAPPING_PORTS = _port_block("", '"Http", "http"')
MULTI_NETWORK = '''
job "foo" {
    task "bar" {
        driver = "docker"
        resources {
            network { mbits = "100" }
            network { mbits = "200" }
        }
    }
}
'''
MULTI_RESOURCE = '''
job "foo" {
    task "bar" {
        driver = "docker"
        resources { cpu = 100 }
        resources { cpu = 200 }
    }
}
'''

GOOD = {
    "web_app": WEB_APP,
    "basic": BASIC,
    "default_job": DEFAULT_JOB,
    "specify_job": SPECIFY_JOB,
    "version_constraint": VERSION_CONSTRAINT,
    "regexp_constraint": REGEXP_CONSTRAINT,
    "distinct_hosts": DISTINCT_HOSTS,
    "merged_meta": MERGED_META,
    "cli_init_example": EXAMPLE_JOB,
}
GOOD.update({f"chip_{job.id}": text for job, text in chip_smoke.agent_jobs()})

BAD = {
    "empty": "",
    "two_jobs": 'job "a" {}\njob "b" {}',
    "unclosed": 'job "a" { unclosed ',
    "bad_ports": BAD_PORTS,
    "overlapping_ports": OVERLAPPING_PORTS,
    "multi_network": MULTI_NETWORK,
    "multi_resource": MULTI_RESOURCE,
    "bad_duration": 'job "a" {\n    update { stagger = "10 parsecs" }\n}\n',
    "bad_distinct_hosts": ('job "a" {\n    constraint { distinct_hosts = '
                           '"maybe" }\n}\n'),
}


def test_cli_init_example_is_nomad_tpus():
    assert EXAMPLE_JOB == JAX_EXAMPLE_JOB


@pytest.mark.parametrize("name", sorted(GOOD))
def test_spec_parses_to_the_same_job(name):
    text = GOOD[name]
    want = jax_to_dict(jjobspec.parse(text))
    got = port_to_dict(pjobspec.parse(text))
    assert got == want
    # Job.validate (what ``validate`` and ``run`` call) agrees too.
    assert (_error(lambda t: pjobspec.parse(t).validate(), text)
            == _error(lambda t: jjobspec.parse(t).validate(), text))


def _error(parse, text):
    try:
        parse(text)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_spec_gives_the_same_error(name):
    want = _error(jjobspec.parse, BAD[name])
    assert want is not None, f"nomad_tpu accepted {name}"
    assert _error(pjobspec.parse, BAD[name]) == want


def test_parse_file_and_durations(tmp_path):
    path = tmp_path / "web.hcl"
    path.write_text(WEB_APP)
    assert (port_to_dict(pjobspec.parse_file(str(path)))
            == jax_to_dict(jjobspec.parse_file(str(path))))
    for value in ("60s", "10m", "1h30m", "250ms", "1.5h", 0, 5_000_000_000):
        assert pjobspec.parse_duration(value) == jjobspec.parse_duration(
            value)
    for bad in ("10 parsecs", "5", "m"):
        assert (_error(pjobspec.parse_duration, bad)
                == _error(jjobspec.parse_duration, bad))
